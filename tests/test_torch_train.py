"""The ported training slice against the JAX package (omnivggt_tpu.train).

The same numpy inputs (from a seed) and the same weights (the JAX package's
init, bridged with params_from_jax) go through both packages:

  - losses: each loss, with and without camera_valid (rtol 1e-5);
  - make_train_step over 3 steps: losses, grad_norm and the final
    parameters;
  - a B=2 step on a batch from the shard stream (batch_stream);
  - remat (True, "dots" against the JAX package's "dots"), stochastic
    depth, descent, checkpoints, the dataset, view ranking, metric logging
    and the training CLI (scene folders and shards).
The optimizer is in tests/test_torch_optim.py.
"""

import dataclasses
import json
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from omnivggt_tpu.data import dataset as JD
from omnivggt_tpu.data import view_selection as JV
from omnivggt_tpu.train import losses as JLS
from omnivggt_tpu.train import step as JS
from omnivggt_tpu_torch import config as TC
from omnivggt_tpu_torch.checkpoint import params_from_jax
from omnivggt_tpu_torch.data import dataset as TD
from omnivggt_tpu_torch.data import view_selection as TV
from omnivggt_tpu_torch.models import omnivggt as TM
from omnivggt_tpu_torch.train import checkpointing as TCK
from omnivggt_tpu_torch.train import losses as TLS
from omnivggt_tpu_torch.train import step as TS
from tests.torch_port_util import (
    HW, assert_trees_close, jax_loss_grads, port_loss_grads, random_cameras, t, tbatch, tiny_pair,
    to_np, train_batch,
)

# ---------------------------------------------------------------------------
# losses


@pytest.mark.parametrize("camera_valid", [None, [True, False, True]])
def test_losses_match_jax(camera_valid):
    rng = np.random.default_rng(1)
    S = 3
    batch = train_batch(S, seed=2)
    if camera_valid is not None:
        batch["camera_valid"] = np.array(camera_valid)
    preds = {
        "pose_enc_list": rng.normal(size=(4, 1, S, 9)).astype(np.float32),
        "depth": rng.uniform(0.5, 5, size=(1, S, HW, HW, 1)).astype(np.float32),
        "depth_conf": (1 + rng.exponential(size=(1, S, HW, HW))).astype(np.float32),
        "world_points": rng.normal(size=(1, S, HW, HW, 3)).astype(np.float32),
        "world_points_conf": (1 + rng.exponential(size=(1, S, HW, HW))).astype(np.float32),
    }
    want = JLS.total_loss({k: jnp.asarray(v) for k, v in preds.items()},
                          {k: jnp.asarray(v) for k, v in batch.items()}, (HW, HW))
    got = TLS.total_loss({k: t(v) for k, v in preds.items()}, tbatch(batch), (HW, HW))
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key].item(), float(want[key]), rtol=1e-5, err_msg=key)


# ---------------------------------------------------------------------------
# remat and stochastic depth


@pytest.mark.parametrize("drop_path", [0.0, 0.5])
def test_remat_gradients_equal_no_remat(drop_path):
    """Recomputing each layer pair gives the gradients of keeping it, with
    stochastic depth too: the keep masks are drawn before the checkpoint,
    so the recomputation drops the same samples."""
    _, tcfg, _, model = tiny_pair(seed=3)
    tcfg = dataclasses.replace(
        tcfg, aggregator=dataclasses.replace(tcfg.aggregator, drop_path_rate=drop_path))
    batch = train_batch(S=2, seed=6)
    out = []
    for remat in (True, False):
        gen = torch.Generator().manual_seed(7)
        out.append(port_loss_grads(model, tcfg, batch, "flash", remat=remat,
                                    train_generator=gen))
    assert out[0][0] == out[1][0]
    assert_trees_close(out[0][1], out[1][1], rel=0.0, floor=1e-7)


def test_remat_dots_matches_jax_and_full_remat():
    """remat="dots" (the linear layers' outputs kept, the rest recomputed)
    against the JAX package's remat="dots" (jax.checkpoint with
    dots_with_no_batch_dims_saveable), and equal to the port's remat=True:
    saving a product's output or recomputing it gives the same numbers.
    Attention is recomputed under both policies, as the Pallas call is under
    jax.checkpoint: the attention Function's forward runs as often."""
    from omnivggt_tpu_torch.ops.kernels import flash_attention as FK

    jcfg, tcfg, params, model = tiny_pair(seed=4)
    batch = train_batch(S=2, seed=8)
    loss_j, grads_j = jax_loss_grads(params, jcfg, batch, "xla", remat="dots")
    calls, plain = {}, FK.attention_plain
    for remat in ("dots", True, False):
        n = [0]

        def counting(*a, **kw):
            n[0] += kw.get("return_lse", False)
            return plain(*a, **kw)

        with mock.patch.object(FK, "attention_plain", counting):
            calls[remat] = (port_loss_grads(model, tcfg, batch, "flash", remat=remat), n[0])
    (loss_t, grads_t), n_dots = calls["dots"]
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-5)
    assert_trees_close(grads_t, params_from_jax(grads_j, tcfg), rel=1e-4, floor=1e-7)
    (loss_full, grads_full), n_full = calls[True]
    assert loss_full == loss_t
    assert_trees_close(grads_t, grads_full, rel=0.0)
    # every aggregator attention runs twice under either policy, once without
    n_none = calls[False][1]
    assert n_dots == n_full == n_none + 2 * tcfg.aggregator.depth > n_none


def test_drop_path_generator():
    """The same generator seed reproduces, another seed differs, and
    without a generator (eval) the forward is deterministic."""
    _, tcfg, _, model = tiny_pair(seed=3)
    tcfg = dataclasses.replace(
        tcfg, aggregator=dataclasses.replace(tcfg.aggregator, drop_path_rate=0.5))
    images = t(train_batch(S=2)["images"])

    def depth(seed=None):
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return TM.apply(model, images, tcfg, train_generator=gen)["depth"]

    assert torch.equal(depth(1), depth(1))
    assert not torch.equal(depth(1), depth(2))
    assert torch.equal(depth(), depth())
    assert not torch.equal(depth(1), depth())


# ---------------------------------------------------------------------------
# the train step


def test_train_step_matches_jax():
    """make_train_step (use_aux_inputs, remat, drop_path 0) in both
    packages over 3 steps on the same batch: losses, grad_norm and the
    final parameters."""
    jcfg, tcfg, params, model = tiny_pair(seed=0)
    batch = train_batch(S=2, seed=7)
    hp = dict(learning_rate=1e-3, warmup_steps=1, total_steps=100)
    opt_j = JS.make_optimizer(**hp)
    step_j = JS.make_train_step(jcfg, opt_j, use_aux_inputs=True, remat=True)
    state_j = JS.init_state(jax.tree.map(jnp.asarray, params), opt_j)
    opt_t = TS.make_optimizer(model, **hp)
    step_t = TS.make_train_step(tcfg, opt_t, use_aux_inputs=True, remat=True)
    state_t = TS.init_state(model, opt_t)
    jb, tb = {k: jnp.asarray(v) for k, v in batch.items()}, tbatch(batch)
    for _ in range(3):
        state_j, m_j = step_j(state_j, jb)
        state_t, m_t = step_t(state_t, tb)
        assert m_t.keys() == m_j.keys()
        for key in m_j:
            np.testing.assert_allclose(m_t[key].item(), float(m_j[key]), rtol=2e-5, err_msg=key)
    assert state_t.step == 3
    # Adam divides each element's gradient by its own running magnitude, so
    # an element whose gradient is near zero moves by a step that fp32
    # rounding differences between the frameworks can change: 2e-5 is 2% of
    # one learning-rate-sized (1e-3) step
    want = params_from_jax(to_np(state_j.params), tcfg)
    assert_trees_close(dict(model.named_parameters()), want, rel=0.0, floor=2e-5)


def _stream_batch(scenes, tmp_path, n=2, views=2):
    """A B=n batch the way the CLI's --shards mode makes it: SceneDataset
    samples written to shards, streamed, and stacked by batch_stream."""
    from omnivggt_tpu_torch.data.streaming import ShardedSampleStream, batch_stream, write_shards

    ds = TD.SceneDataset(str(scenes), views_per_sample=views, target_size=HW, seed=2)
    write_shards((ds.sample() for _ in range(n)), str(tmp_path / "shards"), samples_per_shard=1)
    stream = ShardedSampleStream(str(tmp_path / "shards" / "shard-*.tar"), shuffle_buffer=4,
                                 seed=0, repeat=False)
    return next(iter(batch_stream(stream, n)))


def test_train_step_b2_from_shards_matches_jax(scenes, tmp_path):
    """make_train_step at B=2 on a batch from the shard stream ((2, S)
    camera/depth masks and camera_valid, per-sample GT): 3 steps in both
    packages, losses, grad_norm and the final parameters, as
    test_train_step_matches_jax holds B=1."""
    batch = _stream_batch(scenes, tmp_path)
    assert batch["images"].shape == (2, 2, HW, HW, 3) and batch["camera_mask"].shape == (2, 2)
    assert not np.array_equal(batch["images"][0], batch["images"][1])
    jcfg, tcfg, params, model = tiny_pair(seed=0)
    hp = dict(learning_rate=1e-3, warmup_steps=1, total_steps=100)
    opt_j = JS.make_optimizer(**hp)
    step_j = JS.make_train_step(jcfg, opt_j, use_aux_inputs=True, remat=True)
    state_j = JS.init_state(jax.tree.map(jnp.asarray, params), opt_j)
    opt_t = TS.make_optimizer(model, **hp)
    step_t = TS.make_train_step(tcfg, opt_t, use_aux_inputs=True, remat=True)
    state_t = TS.init_state(model, opt_t)
    jb, tb = {k: jnp.asarray(v) for k, v in batch.items()}, tbatch(batch)
    for _ in range(3):
        state_j, m_j = step_j(state_j, jb)
        state_t, m_t = step_t(state_t, tb)
        assert m_t.keys() == m_j.keys()
        for key in m_j:
            np.testing.assert_allclose(m_t[key].item(), float(m_j[key]), rtol=2e-5, err_msg=key)
    want = params_from_jax(to_np(state_j.params), tcfg)
    assert_trees_close(dict(model.named_parameters()), want, rel=0.0, floor=2e-5)


def test_train_step_descends():
    _, tcfg, _, model = tiny_pair(seed=0)
    opt = TS.make_optimizer(model, learning_rate=1e-3, warmup_steps=1, total_steps=100)
    step = TS.make_train_step(tcfg, opt, use_aux_inputs=True)
    state, batch = TS.init_state(model, opt), tbatch(train_batch())
    losses = []
    for _ in range(8):
        state, metrics = step(state, batch)
        losses.append(metrics["total"].item())
        assert metrics["grad_norm"].item() > 0
    assert np.isfinite(losses).all()
    # the first step is warmup (learning rate 0)
    assert min(losses[2:]) < losses[0]


def test_train_step_refuses_what_is_not_ported():
    """The serving-only modes, an unknown remat, state sharding without a
    mesh, the fused ring (no backward) and a state not laid out for the
    step are refused; a step on a (1, 2) mesh under zero2 runs on the CPU."""
    from omnivggt_tpu_torch.parallel import fsdp
    from omnivggt_tpu_torch.parallel.mesh import make_mesh
    from omnivggt_tpu_torch.parallel.sharding import ModelSharding

    _, tcfg, _, model = tiny_pair(seed=0)
    opt = TS.make_optimizer(model)
    with pytest.raises(ValueError, match="serving-only"):
        TS.make_train_step(dataclasses.replace(tcfg, attn_quant="int8"), opt)
    with pytest.raises(ValueError, match="remat='foo'"):
        TS.make_train_step(tcfg, opt, remat="foo")
    with pytest.raises(ValueError, match="state_sharding needs a ModelSharding"):
        TS.make_train_step(tcfg, opt, state_sharding="zero2")
    mesh = make_mesh(data=1, seq=2, device="cpu")
    with pytest.raises(ValueError, match="ring kernels have no backward"):
        TS.make_train_step(tcfg, opt, ModelSharding(mesh, "ring_fused"))
    step = TS.make_train_step(tcfg, opt, ModelSharding(mesh), use_aux_inputs=True,
                              state_sharding="zero2")
    state = TS.init_state(model, opt)
    with pytest.raises(ValueError, match="laid out for state_sharding='none'"):
        step(state, tbatch(train_batch()))
    state, metrics = step(fsdp.shard_state(state, mesh, "zero2", min_elems=0),
                          tbatch(train_batch()))
    assert state.layout.mode == "zero2" and np.isfinite(metrics["total"].item())


# ---------------------------------------------------------------------------
# checkpoints, data, logging, CLI


def test_checkpoint_roundtrip_keep_last(tmp_path):
    """Save/resume round trip (model, optimizer moments and count, step):
    the resumed state's next step equals the original's; keep_last
    prunes older files."""
    _, tcfg, _, model = tiny_pair(seed=0)
    hp = dict(learning_rate=1e-3, warmup_steps=1, total_steps=100)
    opt = TS.make_optimizer(model, **hp)
    step = TS.make_train_step(tcfg, opt, use_aux_inputs=True, remat=False)
    state, batch = TS.init_state(model, opt), tbatch(train_batch())
    for _ in range(3):
        state, _ = step(state, batch)
        TCK.save_train_state(str(tmp_path), state, keep_last=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000002.pt", "step_00000003.pt"]
    assert TCK.latest_checkpoint(str(tmp_path)).endswith("step_00000003.pt")

    other = TM.OmniVGGT(tcfg, device="cpu", seed=5)
    resumed = TCK.resume_or_init(str(tmp_path), TS.init_state(other, TS.make_optimizer(other, **hp)))
    assert resumed.step == 3 and resumed.optimizer.count == 3
    _, m_orig = step(state, batch)
    _, m_res = step(resumed, batch)
    assert m_orig["total"].item() == m_res["total"].item()
    for a, b in zip(model.parameters(), other.parameters()):
        assert torch.equal(a, b)
    fresh = TS.init_state(other, TS.make_optimizer(other, **hp))
    assert TCK.resume_or_init(str(tmp_path / "none"), fresh) is fresh


def _write_scene(root, n=4, seed=0):
    """An example-layout scene: images/, cameras/ (camera-to-world + K) for
    every frame but the last, depths/ (.npy) for the first two."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for d in ("images", "cameras", "depths"):
        (root / d).mkdir(parents=True)
    for i in range(n):
        name = f"frame{i}"
        Image.fromarray(rng.integers(0, 255, (42, 56, 3), np.uint8)).save(root / "images" / f"{name}.png")
        if i < n - 1:
            ang = 0.3 * i
            c2w = np.eye(4)[:3]
            c2w[:, :3] = [[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]]
            c2w[:, 3] = [0.5 * i, 0.1 * i, 0.0]
            K = np.array([[60.0, 0, 28], [0, 60, 21], [0, 0, 1]])
            (root / "cameras" / f"{name}.txt").write_text(
                "\n".join(" ".join(str(x) for x in row) for row in (*c2w, *K)))
        if i < 2:
            np.save(root / "depths" / f"{name}.npy", rng.uniform(0.5, 5, (42, 56)).astype(np.float32))


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("scenes")
    _write_scene(root / "a", seed=0)
    _write_scene(root / "b", seed=1)
    return root


def test_dataset_matches_jax(scenes):
    """SceneDataset samples (views, GT, dropout masks, normalised world
    points) equal the JAX package's for the same seed."""
    kw = dict(views_per_sample=3, target_size=28, seed=3)
    ds_t, ds_j = TD.SceneDataset(str(scenes), **kw), JD.SceneDataset(str(scenes), **kw)
    assert len(ds_t) == len(ds_j) == 2
    for _ in range(3):
        a, b = ds_t.sample(), ds_j.sample()
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_allclose(np.asarray(a[key], np.float64), np.asarray(b[key], np.float64),
                                       atol=1e-5, err_msg=key)
    batches = list(TD.prefetch(TD.SceneDataset(str(scenes), **kw).batches(2)))
    assert len(batches) == 2 and batches[0]["images"].shape == (1, 3, 28, 28, 3)


@pytest.mark.parametrize("row_chunk", [0, 3, 4, 12])
def test_pairwise_distance_and_rotation_angle_match_jax(row_chunk):
    """rotation_angle_deg, and pairwise_extrinsic_distance with and without
    its row chunks (3 divides N = 12; 4 too; 12 is not below N, so one
    pass), against the JAX package's."""
    rng = np.random.default_rng(9)
    ex, _ = random_cameras(rng, 1, 12)
    ex = ex[0]
    for i, j in ((0, 1), (2, 7), (5, 5)):
        np.testing.assert_allclose(TV.rotation_angle_deg(ex[i, :, :3], ex[j, :, :3]),
                                   float(JV.rotation_angle_deg(ex[i, :, :3], ex[j, :, :3])),
                                   atol=2e-2 if i == j else 1e-4)
    got = TV.pairwise_extrinsic_distance(ex, 0.7, row_chunk=row_chunk)
    want = np.asarray(JV.pairwise_extrinsic_distance(jnp.asarray(ex), 0.7, row_chunk=row_chunk))
    assert got.shape == (12, 12) and got.dtype == np.float32
    # off the diagonal within fp32 rounding; on it, arccos is steep at 1
    off = ~np.eye(12, dtype=bool)
    np.testing.assert_allclose(got[off], want[off], rtol=0, atol=2e-5)
    np.testing.assert_allclose(got[~off], want[~off], rtol=0, atol=5e-4)
    np.testing.assert_array_equal(got, TV.pairwise_extrinsic_distance(ex, 0.7))


def test_view_ranking_matches_jax():
    rng = np.random.default_rng(8)
    ex, _ = random_cameras(rng, 1, 7)
    E = np.tile(np.eye(4, dtype=np.float32), (7, 1, 1))
    E[:, :3] = ex[0]
    got, want = TV.compute_ranking(E), JV.compute_ranking(E)
    np.testing.assert_array_equal(got[0], want[0])
    # fp32: the diagonal's expanded |t_i|^2 - 2 t_i.t_j + |t_j|^2 cancels
    # and arccos is steep at 1, so self-distances differ by ~1e-4
    np.testing.assert_allclose(got[1], want[1], atol=5e-4)


def test_metric_logger(tmp_path):
    from omnivggt_tpu_torch.utils.logging import MetricLogger, SmoothedValue

    sv = SmoothedValue(window_size=3)
    for v in (1.0, 2.0, 3.0, 4.0):
        sv.update(v)
    assert sv.median == 3.0 and sv.global_avg == 2.5 and sv.value == 4.0
    ml = MetricLogger(jsonl_path=str(tmp_path / "log.jsonl"))
    ml.update(loss=torch.tensor(1.5), acc=0.9)
    ml.update(loss=0.5, acc=1.0)
    assert abs(ml.loss.global_avg - 1.0) < 1e-9
    lines = (tmp_path / "log.jsonl").read_text().strip().splitlines()
    assert [json.loads(x)["loss"] for x in lines] == [1.5, 0.5]
    assert list(ml.log_every(range(5), print_freq=2, header="t")) == list(range(5))


def test_train_cli_tiny(scenes, tmp_path):
    """--tiny --device cpu trains, logs and saves; a second run resumes;
    --mesh 1,2 trains on logical ranks, with --state_sharding zero2 too;
    --state_sharding without --mesh and a data axis that does not divide
    the batch are refused; shards made by make_shards train at --batch 2,
    log, save and resume; without --device the default cuda raises here."""
    from omnivggt_tpu_torch.tools import train

    ck = tmp_path / "run"
    base = ["--data_root", str(scenes), "--tiny", "--device", "cpu", "--views", "2",
            "--target_size", "28", "--ckpt_dir", str(ck), "--log_every", "1", "--save_every", "1",
            "--warmup", "1"]
    state = train.main(base + ["--steps", "2"])
    assert state.step == 2 and TCK.latest_checkpoint(str(ck)).endswith("step_00000002.pt")
    assert len((ck / "metrics.jsonl").read_text().splitlines()) == 2
    state = train.main(base + ["--steps", "3"])
    assert state.step == 3 and state.optimizer.count == 3
    for i, extra in enumerate((["--mesh", "1,2"], ["--state_sharding", "zero2", "--mesh", "1,2"])):
        ck_mesh = tmp_path / f"run_mesh{i}"
        state = train.main([str(ck_mesh) if a == str(ck) else a for a in base]
                           + ["--steps", "2", *extra])
        assert state.step == 2 and TCK.latest_checkpoint(str(ck_mesh)).endswith("step_00000002.pt")
        assert (state.layout is None) == (i == 0)
    with pytest.raises(SystemExit, match="--state_sharding requires --mesh"):
        train.main(base + ["--steps", "1", "--state_sharding", "zero2"])
    with pytest.raises(SystemExit, match="must divide the batch size 1"):
        train.main(base + ["--steps", "1", "--mesh", "2,1"])
    from omnivggt_tpu_torch.tools import make_shards

    make_shards.main(["--data_root", str(scenes), "--out", str(tmp_path / "shards"),
                      "--num_samples", "6", "--views", "2", "--target_size", "28",
                      "--samples_per_shard", "2"])
    ck = tmp_path / "run_shards"
    shards = ["--shards", str(tmp_path / "shards" / "shard-*.tar"), "--batch", "2", "--tiny",
              "--device", "cpu", "--ckpt_dir", str(ck), "--log_every", "1", "--save_every", "1",
              "--warmup", "1"]
    state = train.main(shards + ["--steps", "2"])
    assert state.step == 2 and TCK.latest_checkpoint(str(ck)).endswith("step_00000002.pt")
    logged = [json.loads(x) for x in (ck / "metrics.jsonl").read_text().splitlines()]
    assert [m["step"] for m in logged] == [1, 2]
    assert all(np.isfinite(m["total"]) and m["grad_norm"] > 0 for m in logged)
    state = train.main(shards + ["--steps", "3"])
    assert state.step == 3 and state.optimizer.count == 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(["--data_root", str(scenes), "--tiny", "--steps", "1"])


def test_train_toy_example(tmp_path):
    """The toy loop on a logical (2, 2) mesh under fsdp: trains, logs,
    saves, and resumes to a later step; the loss descends."""
    from omnivggt_tpu_torch.examples import train_toy

    argv = ["--ranks", "4", "--state_sharding", "fsdp", "--device", "cpu",
            "--ckpt_dir", str(tmp_path)]
    state = train_toy.main(argv + ["--steps", "4"])
    assert state.step == 4 and state.layout.mode == "fsdp"
    assert (state.layout.mesh.data, state.layout.mesh.seq) == (2, 2)
    losses = [json.loads(x)["total"] for x in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert len(losses) == 4 and losses[-1] < losses[0]
    assert train_toy.main(argv + ["--steps", "5"]).step == 5
    assert TCK.latest_checkpoint(str(tmp_path)).endswith("step_00000005.pt")


def test_train_cli_checkpoint_load_certifies_no_fast_mode(scenes, tmp_path):
    """--checkpoint starts training from a reference checkpoint with the
    config's own head dtype: the load runs no certification ladder (no
    certificate appears), so no serving-only mode reaches make_train_step."""
    from safetensors.torch import save_file

    from omnivggt_tpu_torch.tools import train

    src = TM.OmniVGGT(TC.tiny_test_config(), device="cpu", seed=5)
    path = tmp_path / "model.safetensors"
    save_file({k: v.contiguous() for k, v in src.state_dict().items()}, str(path))
    state = train.main(["--data_root", str(scenes), "--tiny", "--device", "cpu", "--views", "2",
                        "--target_size", "28", "--ckpt_dir", str(tmp_path / "run"),
                        "--warmup", "1", "--steps", "1", "--checkpoint", str(path)])
    assert state.step == 1
    assert not (tmp_path / "model.safetensors.certified.json").exists()
