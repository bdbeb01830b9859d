"""The port's serving layer on the CPU at a tiny size: the session against
the JAX package's session on the same requests, bucketed == exact, batched
inference, the Batcher, deadlines, the HTTP endpoint, warmup, and the
certificate file read across both packages.
"""

import dataclasses
import io
import json
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from omnivggt_tpu import certification as JCert
from omnivggt_tpu import serving as JS
from omnivggt_tpu.models import omnivggt as JM
from omnivggt_tpu_torch import certification as TCert
from omnivggt_tpu_torch import serving as TS
from omnivggt_tpu_torch.models import omnivggt as TM
from tests.torch_port_util import OUTPUT_KEYS, tiny_pair

HW = 28


@pytest.fixture(scope="module")
def pair():
    return tiny_pair(seed=0)


@pytest.fixture(scope="module")
def model(pair):
    return pair[3]


def _images(S, seed=0):
    return np.random.default_rng(seed).uniform(size=(S, HW, HW, 3)).astype(np.float32)


def _aux(S, seed=5):
    rng = np.random.default_rng(seed)
    ex = np.tile(np.eye(3, 4, dtype=np.float32), (S, 1, 1))
    ex[:, :3, 3] = rng.normal(size=(S, 3))
    K = np.tile(np.diag([30.0, 30.0, 1.0]).astype(np.float32), (S, 1, 1))
    K[:, 0, 2] = K[:, 1, 2] = 14
    return dict(
        extrinsics=ex, intrinsics=K,
        depth=rng.uniform(0.5, 3.0, size=(S, HW, HW, 1)).astype(np.float32),
        mask=np.ones((S, HW, HW), np.float32), camera_gt_index=[0, 2], depth_gt_index=[1],
    )


def _free_port():
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _post(port, path, body, headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body, method="POST",
                                 headers=headers or {})
    return urllib.request.urlopen(req, timeout=60)


def _npz(**arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


@pytest.mark.parametrize("with_aux", [False, True], ids=["images", "aux"])
def test_bucketed_equals_exact_and_the_jax_session(pair, with_aux):
    """A 3-frame scene through the 4-bucket (padded frame masked out of
    every cross-frame attention) matches the exact session (atol 2e-5,
    rtol 1e-5, the JAX test's) and the JAX package's bucketed session on
    the same request (the module tolerance 5e-4)."""
    jcfg, _, params, model = pair
    bucketed = TS.InferenceSession(model, buckets=(4,), pad_mode="bucket")
    exact = TS.InferenceSession(model, buckets=(4,), pad_mode="exact")
    assert TS.InferenceSession(model).pad_mode == "bucket"  # the default
    kw = _aux(3) if with_aux else {}
    imgs = _images(3, seed=5)
    out_b, out_e = bucketed.infer(imgs, **kw), exact.infer(imgs, **kw)
    assert list(bucketed._served) == [(4, HW, HW, with_aux, with_aux, True, 1)]
    assert list(exact._served) == [(3, HW, HW, with_aux, with_aux, False, 1)]
    assert out_b.keys() == out_e.keys() and "pose_enc_list" in out_b
    for k in out_e:
        assert out_b[k].shape == out_e[k].shape, k
        np.testing.assert_allclose(out_b[k], out_e[k], atol=2e-5, rtol=1e-5, err_msg=k)
    assert out_b["depth"].shape == (3, HW, HW, 1) and out_b["pose_enc_list"].shape[1:] == (3, 9)
    out_j = JS.InferenceSession(JM.OmniVGGT(jcfg, params), buckets=(4,)).infer(imgs, **kw)
    for k in OUTPUT_KEYS + ("pose_enc_list", "images"):
        np.testing.assert_allclose(out_b[k], np.asarray(out_j[k]), atol=5e-4, rtol=1e-4, err_msg=k)


def test_padded_request_hands_the_model_a_device_scalar(model, monkeypatch):
    """A padded request passes num_valid_frames as an int32 scalar tensor
    on the model's device (the kernels' dynamic variant, no host sync); an
    exact-fit request passes None."""
    seen = []
    apply = TM.apply
    monkeypatch.setattr(TM, "apply", lambda *a, **k: (seen.append(k["num_valid_frames"]),
                                                      apply(*a, **k))[1])
    session = TS.InferenceSession(model, buckets=(2, 4))
    session.infer(_images(3))
    session.infer(_images(4))
    nv, none = seen
    assert none is None
    assert isinstance(nv, torch.Tensor) and nv.dtype == torch.int32 and nv.shape == ()
    assert nv.device == session.device and int(nv) == 3


def test_session_bucketing_and_bad_input(model):
    session = TS.InferenceSession(model, buckets=(2, 4, 8))
    assert [session._bucket(s) for s in (1, 2, 3, 5, 8, 9)] == [2, 2, 4, 8, 8, 9]
    assert TS.InferenceSession(model, pad_mode="exact")._bucket(3) == 3
    assert TS.DEFAULT_BUCKETS == JS.DEFAULT_BUCKETS
    with pytest.raises(ValueError, match="multiples of patch size"):
        session.infer(np.zeros((2, 30, 30, 3), np.float32))
    with pytest.raises(ValueError, match=r"\[0,1\]"):
        session.infer(_images(2) * 3)
    with pytest.raises(ValueError, match="requires extrinsics"):
        session.infer(_images(2), camera_gt_index=[0])
    with pytest.raises(ValueError, match="pad_mode"):
        TS.InferenceSession(model, pad_mode="round")
    # a sharding is taken (tests/test_torch_parallel.py serves through one);
    # bucket mode refuses the ring strategies in the JAX package's words
    from omnivggt_tpu_torch.parallel.mesh import make_mesh
    from omnivggt_tpu_torch.parallel.sharding import ModelSharding

    ring = ModelSharding(make_mesh(seq=2, device="cpu"), "ring_fused")
    with pytest.raises(ValueError, match="ring strategies do not support"):
        TS.InferenceSession(model, sharding=ring)
    assert TS.InferenceSession(model, sharding=ring, pad_mode="exact").sharding is ring
    # the default device is cuda: without one, a session that builds its own
    # model raises instead of running on the CPU
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TS.InferenceSession(config=model.config)


def test_fast_mode_session_and_compressed_trunk(pair):
    """A session serves the model's own config: the certified fast modes
    (int8 trunk and scores, tanh GELU) give a close but different answer;
    a bf16-stored trunk stays close too."""
    _, tcfg, _, model = pair
    imgs = _images(3, seed=2)
    base = TS.InferenceSession(model, buckets=(4,)).infer(imgs)
    fast_model = TM.OmniVGGT(
        dataclasses.replace(tcfg, trunk_quant="int8", attn_quant="int8", approx_gelu=True),
        device="cpu", seed=None)
    fast_model.load_state_dict(model.state_dict())
    fast = TS.InferenceSession(fast_model, buckets=(4,)).infer(imgs)
    delta = np.abs(fast["depth"] - base["depth"]).max()
    assert 0 < delta < 5e-2
    compressed = TS.InferenceSession(
        TM.OmniVGGT(tcfg, device="cpu", seed=0), buckets=(4,), compress_trunk=True)
    assert compressed.model.aggregator.frame_blocks[0].attn.qkv.weight.dtype == torch.bfloat16
    assert np.isfinite(compressed.infer(imgs)["world_points"]).all()


def test_infer_batch_stacks_compatible_scenes(model, monkeypatch):
    """Compatible scenes share one batched forward; results keep their
    order and match the single-scene path."""
    session = TS.InferenceSession(model, buckets=(2, 4), pad_mode="exact")
    scenes = [_images(2, 1), _images(3, 2), _images(2, 3), _images(2, 4)]
    batches = []
    execute = session._execute
    monkeypatch.setattr(session, "_execute", lambda reqs: (batches.append(len(reqs)),
                                                           execute(reqs))[1])
    outs = session.infer_batch([{"images": s} for s in scenes], max_batch=2)
    assert sorted(batches) == [1, 1, 2]  # three S=2 scenes in chunks of 2, one S=3
    for scene, out in zip(scenes, outs):
        single = session.infer(scene)
        for k in OUTPUT_KEYS:
            np.testing.assert_allclose(out[k], single[k], atol=2e-5, err_msg=k)


def test_batcher_coalesces_concurrent_requests(model, monkeypatch):
    """Two concurrent same-key requests become one B=2 forward."""
    session = TS.InferenceSession(model, buckets=(2,), pad_mode="exact")
    batches = []
    execute = session._execute
    monkeypatch.setattr(session, "_execute", lambda reqs: (batches.append(len(reqs)),
                                                           execute(reqs))[1])
    batcher = TS.Batcher(session, max_batch=4, window_ms=300.0)
    results = {}

    def submit(i):
        results[i] = batcher.submit(timeout=120.0, images=_images(2, seed=i))

    threads = [threading.Thread(target=submit, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    batcher.close()
    assert batches == [2]
    for i in range(2):
        single = session.infer(_images(2, seed=i))
        np.testing.assert_allclose(results[i]["depth"], single["depth"], atol=2e-5)


def test_deadlines_release_the_caller(model, monkeypatch):
    """A hanging dispatch delivers InferenceTimeout from the Batcher and
    from the deadline wrapper; errors inside the deadline stay themselves."""
    session = TS.InferenceSession(model, buckets=(2,), pad_mode="exact")
    out = TS._call_with_deadline(session.infer, 120.0, images=_images(2))
    assert out["pose_enc"].shape == (2, 9)
    with pytest.raises(TS.InferenceTimeout):
        TS._call_with_deadline(lambda **kw: time.sleep(30), 0.2, images=None)
    with pytest.raises(ValueError, match="bad scene"):
        TS._call_with_deadline(lambda **kw: (_ for _ in ()).throw(ValueError("bad scene")), 5.0)
    assert issubclass(TS.InferenceTimeout, TimeoutError)

    release = threading.Event()
    monkeypatch.setattr(session, "_execute", lambda reqs: release.wait(30.0))
    batcher = TS.Batcher(session, window_ms=1.0)
    t0 = time.monotonic()
    with pytest.raises(TS.InferenceTimeout):
        batcher.submit(timeout=0.3, images=_images(2))
    assert time.monotonic() - t0 < 5.0
    release.set()
    batcher.close()


def test_backend_probe_states():
    """ok on a live device, wedged when the probe hangs past its deadline."""
    ok = TS.BackendProbe(interval_s=60.0, timeout_s=5.0, device="cpu")
    for _ in range(100):
        st = ok.status()
        if st["backend"] != "unknown":
            break
        time.sleep(0.05)
    assert st["backend"] == "ok" and ok.status()["backend"] == "ok"
    hang = threading.Event()
    wedged = TS.BackendProbe(interval_s=60.0, timeout_s=0.2, device="cpu")
    wedged._probe_once = lambda: hang.wait(30.0)
    wedged.status()
    time.sleep(0.3)
    assert wedged.status() == {"backend": "wedged", "age_s": 0.0}
    hang.set()
    down = TS.BackendProbe(interval_s=60.0, timeout_s=5.0, device="cpu")
    down._probe_once = lambda: (_ for _ in ()).throw(RuntimeError("device lost"))
    down.status()
    time.sleep(0.2)
    assert down.status()["backend"] == "wedged"


def test_http_endpoint(model):
    """POST /infer with an .npz body, GET /healthz, bearer auth, a
    malformed body (400), an unknown path (404) and /infer_glb (501)."""
    session = TS.InferenceSession(model, buckets=(2, 4))
    port = _free_port()
    httpd, _ = TS.serve(session, port=port, background=True, token="s3cret",
                        probe=TS.BackendProbe(device="cpu"))
    auth = {"Authorization": "Bearer s3cret"}
    try:
        imgs = _images(3, seed=9)
        body = _npz(images=imgs, **{k: np.asarray(v) for k, v in _aux(3).items()})
        with _post(port, "/infer", body, auth) as r:
            assert r.status == 200 and float(r.headers["X-Inference-Seconds"]) >= 0
            got = np.load(io.BytesIO(r.read()))
        want = session.infer(imgs, **_aux(3))
        assert "images" not in got.files
        for k in OUTPUT_KEYS:
            np.testing.assert_allclose(got[k], want[k], atol=2e-5, err_msg=k)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["ready"] is True
        assert health["buckets"] == [2, 4] and health["batching"] is False
        assert str((4, HW, HW, True, True, True, 1)) in health["compiled"]
        for path, headers, code in (("/infer", {}, 401), ("/infer", {"Authorization": "Bearer x"}, 401),
                                    ("/infer_glb", auth, 501), ("/nope", auth, 404)):
            with pytest.raises(urllib.error.HTTPError) as exc:
                _post(port, path, body, headers)
            assert exc.value.code == code, path
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(port, "/infer", b"not-an-npz", auth)
        assert exc.value.code == 400 and "error" in json.loads(exc.value.read())
    finally:
        httpd.shutdown()


def test_http_timeout_returns_503_and_batching(model):
    """A wedged dispatch surfaces as 503 on /infer and degraded on /healthz;
    with a batch window the endpoint goes through the Batcher."""
    session = TS.InferenceSession(model, buckets=(2,), pad_mode="exact")
    release = threading.Event()
    execute = session._execute
    session._execute = lambda reqs: (release.wait(30.0), execute(reqs))[1]
    probe = TS.BackendProbe(interval_s=60.0, timeout_s=0.2, device="cpu")
    probe._probe_once = lambda: release.wait(30.0)
    port = _free_port()
    httpd, _ = TS.serve(session, port=port, background=True, request_timeout_s=0.3, probe=probe,
                        batch_window_ms=1.0)
    try:
        body = _npz(images=_images(2))
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(port, "/infer", body)
        assert exc.value.code == 503
        assert "InferenceTimeout" in json.loads(exc.value.read())["error"]
        probe.status()
        time.sleep(0.3)
        with pytest.raises(urllib.error.HTTPError) as hexc:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=10)
        assert hexc.value.code == 503
        health = json.loads(hexc.value.read())
        assert health["backend"] == "wedged" and health["batching"] is True
    finally:
        release.set()
        httpd.shutdown()


def test_warmup_runs_the_keys_traffic_will_hit(model):
    session = TS.InferenceSession(model, buckets=(2, 4), pad_mode="bucket")
    keys = session.warmup(frame_counts=(4,), hw=(HW, HW))
    assert set(keys) == {(4, HW, HW, False, False, False, 1), (4, HW, HW, False, False, True, 1)}
    session.infer(_images(3))
    session.infer(_images(4))
    assert set(session._served) == set(keys)  # nothing new
    gapless = TS.InferenceSession(model, buckets=(1, 2), pad_mode="bucket")
    assert set(gapless.warmup(frame_counts=(1, 2), hw=(HW, HW))) == {
        (1, HW, HW, False, False, False, 1), (2, HW, HW, False, False, False, 1)}
    combos = TS.InferenceSession(model, buckets=(2,), pad_mode="bucket")
    keys = combos.warmup(frame_counts=(2,), hw=(HW, HW), batch_sizes=(1, 2),
                         include_masked=False, modalities=((True, True),))
    assert set(keys) == {(2, HW, HW, True, True, False, 1), (2, HW, HW, True, True, False, 2)}


def test_healthz_answers_before_warmup_finishes(model):
    """The port binds and /healthz reports warming (200) while warmup runs;
    inference POSTs get 503 until it is over."""
    session = TS.InferenceSession(model, buckets=(2,), pad_mode="exact")
    release = threading.Event()
    real_warmup = session.warmup
    session.warmup = lambda **kw: (release.wait(30.0), real_warmup(**kw))[1]
    port = _free_port()
    result = {}
    th = threading.Thread(
        target=lambda: result.update(ret=TS.serve(
            session, port=port, background=True, warmup_frame_counts=(2,), warmup_hw=(HW, HW),
            probe=TS.BackendProbe(device="cpu"))),
        daemon=True)
    th.start()
    body = _npz(images=_images(2))
    try:
        health, t0 = None, time.time()
        while time.time() - t0 < 10.0 and health is None:
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=5) as r:
                    health = json.loads(r.read())
            except (urllib.error.URLError, ConnectionError):
                time.sleep(0.05)
        assert health is not None and health["status"] == "warming" and health["ready"] is False
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(port, "/infer", body)
        assert exc.value.code == 503 and "warming" in json.loads(exc.value.read())["error"]
    finally:
        release.set()
    th.join(timeout=120)
    httpd, _ = result["ret"]
    try:
        with _post(port, "/infer", body) as r:
            assert r.status == 200
    finally:
        httpd.shutdown()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_certificate_is_read_by_both_packages(pair, tmp_path, writer):
    """The certificate file one package writes next to a checkpoint is
    read by the other: the same format, name, version and fingerprint."""
    jcfg, tcfg, _, _ = pair
    ckpt = tmp_path / "model.safetensors"
    ckpt.write_bytes(np.random.default_rng(0).bytes(4096))
    gates = TM.certification_gates()
    assert gates == JM.certification_gates() and TCert.CERT_VERSION == JCert.CERT_VERSION
    assert TCert.MODE_FIELDS == JCert.MODE_FIELDS
    assert TCert.checkpoint_fingerprint(str(ckpt)) == JCert.checkpoint_fingerprint(str(ckpt))
    modes = dict(head_dtype="bfloat16", approx_gelu=True, trunk_quant="int8_ln", attn_quant="int8")
    if writer == "jax":
        path = JCert.save_certificate(str(ckpt), jcfg, dataclasses.replace(jcfg, **modes), gates)
    else:
        path = TCert.save_certificate(str(ckpt), tcfg, dataclasses.replace(tcfg, **modes), gates)
    assert path == TCert.certificate_path(str(ckpt)) == JCert.certificate_path(str(ckpt))
    for cert, cfg in ((TCert, tcfg), (JCert, jcfg)):
        got = cert.load_certificate(str(ckpt), cfg, gates)
        assert {k: getattr(got, k) for k in modes} == modes and got.head_quant == "none"
        # other gates, another base config or other contents: no verdict
        assert cert.load_certificate(str(ckpt), cfg, {**gates, "pose_tol": 1e-3}) is None
        assert cert.load_certificate(
            str(ckpt), dataclasses.replace(cfg, head_dtype="bfloat16"), gates) is None
    ckpt.write_bytes(b"other weights")
    assert TCert.load_certificate(str(ckpt), tcfg, gates) is None
    # a directory checkpoint keeps its certificate inside, outside the fingerprint
    folder = tmp_path / "ckpt_dir"
    folder.mkdir()
    (folder / "config.json").write_text("{}")
    fp = TCert.checkpoint_fingerprint(str(folder))
    TCert.save_certificate(str(folder), tcfg, tcfg, gates)
    assert TCert.checkpoint_fingerprint(str(folder)) == fp == JCert.checkpoint_fingerprint(str(folder))
