"""The seq axis over processes (parallel/mesh.py, parallel/collectives.py,
parallel/attention.py, ops/kernels/ring_attention.py, models/omnivggt.py,
serving.py): two gloo processes, one seq rank each, against logical ranks
in one process and against the JAX package's single-device forward.

Two processes are spawned once for the module (file:// rendezvous in a
temporary directory, every join and init_process_group with a timeout).
Each builds the tiny config from seed 0 and is given the whole S=4, 28 px
request; it runs the frames of its seq rank. Two GT layouts cross the
processes: cameras on frames 1-3 (the first selected camera in rank 0,
the rest rebased to it in rank 1) and depth on frames 0, 2, 3 with 90% and
30% valid pixels (a mean of the ranks' means would differ from the scene's
mean); and cameras on frames 2, 3 only (the first selected camera in rank
1), depth on 1 and 2. Every forward is held to the logical-rank forward on
make_mesh(data=1, seq=2) within 1e-6, and to the JAX package's forward
within the module tolerance 5e-4.

The spawned processes import no JAX: the module imports it only inside the
tests that run here.
"""

import multiprocessing
import os
import time

import numpy as np
import pytest
import torch

from omnivggt_tpu_torch import config as TC
from omnivggt_tpu_torch.models import omnivggt as TM
from omnivggt_tpu_torch.ops.kernels import flash_attention as FK
from omnivggt_tpu_torch.ops.kernels import ring_attention as RK
from omnivggt_tpu_torch.parallel import collectives as C
from omnivggt_tpu_torch.parallel import mesh as PM
from omnivggt_tpu_torch.parallel.sharding import ModelSharding
from omnivggt_tpu_torch.serving import DEFAULT_BUCKETS, InferenceSession
from omnivggt_tpu_torch.train import step as TS

torch.set_num_threads(1)
S, HW, N_PROC, TOL = 4, 28, 2, 1e-6
STRATEGIES = ("allgather", "ring", "ring_fused")
LAYOUTS = {
    # camera GT, depth GT, valid-pixel density per frame
    "first_camera_in_rank_0": ([1, 2, 3], [0, 2, 3], (0.9, 0.9, 0.3, 0.3)),
    "first_camera_in_rank_1": ([2, 3], [1, 2], (0.9, 0.5, 0.2, 0.9)),
}
OUTPUT_KEYS = ("pose_enc", "pose_enc_list", "depth", "depth_conf", "world_points",
               "world_points_conf", "images")
JOIN_S = 240


def make_request(layout, seed=0):
    """Reference-style keyword arguments of one S=4 scene with the layout's GT."""
    cam, dep, density = LAYOUTS[layout]
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(S, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q.T
    R = np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
                  2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
                  2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
                 -1).reshape(S, 3, 3)
    K = np.zeros((1, S, 3, 3))
    K[..., 0, 0] = K[..., 1, 1] = 30.0
    K[..., 0, 2] = K[..., 1, 2] = HW / 2
    K[..., 2, 2] = 1.0
    mask = rng.uniform(size=(1, S, HW, HW)) < np.asarray(density)[None, :, None, None]
    return {
        "images": rng.uniform(size=(S, HW, HW, 3)).astype(np.float32),
        "extrinsics": np.concatenate([R, 3 * rng.normal(size=(S, 3, 1))], -1)[None]
        .astype(np.float32),
        "intrinsics": K.astype(np.float32),
        "depth": rng.uniform(0.5, 5.0, size=(1, S, HW, HW, 1)).astype(np.float32),
        "mask": mask.astype(np.float32),
        "camera_gt_index": cam,
        "depth_gt_index": dep,
    }


def tiny_model(attn_quant="none"):
    cfg = TC.tiny_test_config()
    if attn_quant != "none":
        import dataclasses

        cfg = dataclasses.replace(cfg, attn_quant=attn_quant)
    model = TM.OmniVGGT(TC.tiny_test_config(), device="cpu", seed=0).eval()
    model.config = cfg
    return model


def forwards(mesh):
    """{(layout, strategy): numpy outputs} and the collectives of one
    allgather forward, on `mesh`."""
    model = tiny_model()
    out, calls = {}, None
    with torch.inference_mode():
        for layout in LAYOUTS:
            req = make_request(layout)
            for strategy in STRATEGIES:
                C.reset_calls()
                preds = model(**req, sharding=ModelSharding(mesh, strategy))
                if (layout, strategy) == ("first_camera_in_rank_0", "allgather"):
                    calls = (C.calls(), C.elements())
                out[layout, strategy] = {k: preds[k].numpy() for k in OUTPUT_KEYS}
    return out, calls


def int8_grids(mesh):
    """The allgather forward under attn_quant="int8" through the head-major
    int8 kernel's plain version (attn_impl "flash"): the gathered K grid and
    scales each call hands the kernel, and the outputs."""
    model = tiny_model("int8")
    seen = []
    real = FK.flash_attention

    def spy(q, k, v, **kw):
        if kw.get("k_quant") is not None:
            seen.append(tuple(x.clone() for x in kw["k_quant"]))
        return real(q, k, v, **kw)

    FK.flash_attention = spy
    try:
        with torch.inference_mode():
            preds = model(**make_request("first_camera_in_rank_0"), attn_impl="flash",
                          sharding=ModelSharding(mesh, "allgather"))
    finally:
        FK.flash_attention = real
    return seen, {k: preds[k].numpy() for k in ("pose_enc", "depth")}


def ring_kernels(mesh):
    """Both ring wrappers' plain versions on random shards: bf16 bounded,
    fp32 running-max and int8, the second kernel ragged (nl 27)."""
    rng = np.random.default_rng(5)
    outs = {}
    for name, nl, dtype, bounded, int8 in (
        ("ring_flash_attention", 32, torch.float32, False, False),
        ("ring_flash_attention", 32, torch.bfloat16, True, True),
        ("ring_flash_attention_hbm", 27, torch.bfloat16, True, False),
        ("ring_flash_attention_hbm", 27, torch.float32, False, True),
    ):
        q, k, v = (torch.tensor(rng.normal(size=(1, N_PROC * nl, 2, 64)) * s, dtype=dtype)
                   for s in (3.0, 1.0, 1.0))
        if mesh.seq_processes:
            rows = slice(mesh.seq_rank * nl, (mesh.seq_rank + 1) * nl)
            q, k, v = q[:, rows], k[:, rows], v[:, rows]
        fn = getattr(RK, name)
        outs[name, dtype, bounded, int8] = fn(q, k, v, mesh, bounded_logits=bounded,
                                              qk_int8=int8).float()
    return outs


def session_answers(mesh):
    """Bucketed sessions under allgather: 3 frames padded to bucket 4; and 1
    frame, which the default buckets put in bucket 1, rounded up to 2 over
    the 2 seq processes (bucket 2 given on logical ranks)."""
    req = make_request("first_camera_in_rank_1")
    out = []
    for frames, cam, dep, buckets in (
            (3, [1, 2], [0, 2], (4,)),
            (1, [0], [0], DEFAULT_BUCKETS if mesh.seq_processes else (2,))):
        session = InferenceSession(tiny_model(), buckets=buckets,
                                   sharding=ModelSharding(mesh, "allgather"))
        one = {k: (v[:frames] if k == "images" else v[:, :frames] if hasattr(v, "ndim") else v)
               for k, v in req.items()}
        one["camera_gt_index"], one["depth_gt_index"] = cam, dep
        out.append((session.infer(**one), dict(session._served)))
    return out


def exact_mode_error(mesh):
    """Exact mode under the ring over the processes, given 1 frame: the
    session refuses it (it cannot pad) before any forward."""
    session = InferenceSession(tiny_model(), sharding=ModelSharding(mesh, "ring"),
                               pad_mode="exact")
    req = make_request("first_camera_in_rank_0")
    try:
        session.infer(req["images"][:1])
    except ValueError as e:
        return str(e), dict(session._served)
    return None, dict(session._served)


def _worker(rank, rdzv, out):
    torch.set_num_threads(1)
    import torch.distributed as dist

    PM.multihost_initialize(device="cpu", init_method=rdzv, world_size=N_PROC, rank=rank,
                            timeout=60)
    results = {}
    for data, seq in ((1, 3), (3, 1), (4, 2)):
        try:
            PM.make_mesh(data=data, seq=seq, device="cpu")
        except ValueError as e:
            results[f"error {data}x{seq}"] = str(e)
    mesh = PM.make_mesh(data=1, seq=N_PROC, device="cpu")
    results["mesh"] = (mesh.seq_processes, mesh.seq_rank, mesh.local_shape, mesh.group is None)
    results["forwards"] = forwards(mesh)
    results["int8"] = int8_grids(mesh)
    results["ring"] = ring_kernels(mesh)
    results["session"] = session_answers(mesh)
    results["exact"] = exact_mode_error(mesh)
    model = tiny_model()
    opt = TS.make_optimizer(model, learning_rate=1e-3, warmup_steps=1, total_steps=10)
    try:
        TS.make_train_step(model.config, opt, ModelSharding(mesh, "allgather"))
    except NotImplementedError as e:
        results["train"] = str(e)
    torch.save(results, os.path.join(out, f"results_{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both processes' results, and the same calls on logical ranks here."""
    out = str(tmp_path_factory.mktemp("seq"))
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(r, f"file://{out}/rdzv", out))
             for r in range(N_PROC)]
    for p in procs:
        p.start()
    t0 = time.monotonic()
    logical = PM.make_mesh(data=1, seq=N_PROC, device="cpu")
    ref = {"forwards": forwards(logical), "int8": int8_grids(logical),
           "ring": ring_kernels(logical), "session": session_answers(logical)}
    deadline = time.monotonic() + JOIN_S
    for p in procs:
        p.join(timeout=max(deadline - time.monotonic(), 1))
    alive = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(timeout=10)
    assert not alive, f"gloo processes {alive} did not finish in {JOIN_S} s"
    assert [p.exitcode for p in procs] == [0] * N_PROC
    got = [torch.load(os.path.join(out, f"results_{r}.pt"), weights_only=False)
           for r in range(N_PROC)]
    return {"ref": ref, "got": got, "seconds": time.monotonic() - t0}


def _close(a, b, label, tol=TOL):
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=label)


def test_mesh_layout_and_its_errors(runs):
    """data x seq == world size lays both axes over the processes, one seq
    rank each; any other shape than data == world raises."""
    for rank, got in enumerate(runs["got"]):
        assert got["mesh"] == (True, rank, {"data": 1, "seq": 1}, True)
        assert set(k for k in got if k.startswith("error")) == {"error 1x3", "error 3x1",
                                                                  "error 4x2"}
        assert "data x seq must be 2" in got["error 1x3"]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_process_forward_matches_logical_ranks(runs, strategy, layout):
    """Every process returns the whole prediction dict, pose_enc_list
    included, within 1e-6 of the logical ranks' forward."""
    want = runs["ref"]["forwards"][0][layout, strategy]
    for got in runs["got"]:
        for key in OUTPUT_KEYS:
            assert got["forwards"][0][layout, strategy][key].shape == want[key].shape
            _close(got["forwards"][0][layout, strategy][key], want[key],
                   f"{strategy} {layout} {key}")


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_process_forward_matches_the_jax_forward(runs, layout):
    """The processes' answer under each strategy against the JAX package's
    single-device forward on the same weights, within 5e-4."""
    import jax
    import jax.numpy as jnp

    from omnivggt_tpu.models import omnivggt as JM
    from tests.torch_port_util import tiny_pair

    jcfg, _, params, _ = tiny_pair(seed=0)
    req = make_request(layout)
    kw = {k: v for k, v in req.items() if k != "images"}
    out_j = jax.jit(lambda p, x, aux: JM.apply(p, x, jcfg, aux))(
        params, jnp.asarray(req["images"][None]), JM.make_aux(S, **kw))
    for strategy in STRATEGIES:
        got = runs["got"][1]["forwards"][0][layout, strategy]
        for key in ("pose_enc", "depth", "depth_conf", "world_points", "world_points_conf"):
            np.testing.assert_allclose(got[key], np.asarray(out_j[key]), atol=5e-4, rtol=1e-4,
                                       err_msg=f"{strategy} {layout} {key}")


def test_layouts_cross_the_processes():
    """Each layout makes the processes depend on each other: the scene's
    depth mean is not the mean of the two ranks' means, and (first layout)
    rank 1's cameras are rebased to a camera that rank 0 holds."""
    for layout, (cam, dep, _) in LAYOUTS.items():
        req = make_request(layout)
        sel = req["mask"][0] * np.isin(np.arange(S), dep)[:, None, None]
        d = req["depth"][0, ..., 0]
        whole = (d * sel).sum() / sel.sum()
        halves = [(d[h] * sel[h]).sum() / max(sel[h].sum(), 1) for h in (slice(0, 2), slice(2, 4))]
        assert abs(np.mean(halves) - whole) > 1e-3 * whole, layout
    assert min(LAYOUTS["first_camera_in_rank_0"][0]) < S // 2
    assert min(LAYOUTS["first_camera_in_rank_1"][0]) >= S // 2


def test_int8_allgather_grids_equal_the_logical_ranks(runs):
    """Under attn_quant="int8" each process quantises its K shard on the max
    over the seq ranks before the gather: the gathered int8 K and its
    scales equal the logical ranks' (every call), and so do the outputs."""
    ref_seen, ref_out = runs["ref"]["int8"]
    depth = TC.tiny_test_config().aggregator.depth
    assert len(ref_seen) == N_PROC * depth
    for got in runs["got"]:
        seen, out = got["int8"]
        assert len(seen) == depth
        for layer, (k8, scale) in enumerate(seen):
            want_k8, want_scale = ref_seen[layer * N_PROC]
            assert k8.dtype == torch.int8 and torch.equal(k8, want_k8), layer
            assert torch.equal(scale, want_scale), layer
        for key in out:
            _close(out[key], ref_out[key], f"int8 {key}")


def test_ring_kernels_process_form(runs):
    """Both ring wrappers' plain versions in the process form (K/V shards
    gathered over gloo, the carry for the own rank) equal each rank's rows
    of the logical form."""
    for rank, got in enumerate(runs["got"]):
        for key, want in runs["ref"]["ring"].items():
            nl = want.shape[1] // N_PROC
            assert torch.equal(got["ring"][key], want[:, rank * nl:(rank + 1) * nl]), key


def test_session_in_bucket_mode(runs):
    """A bucketed session under allgather over the processes: 3 frames in
    bucket 4 (rank 1 holds frame 2 and the padding), and 1 frame, its
    bucket 1 rounded up to 2 (rank 1 holds only padding): the logical
    session's answer in the same bucket, padding stripped."""
    want = runs["ref"]["session"]
    assert [served for _, served in want] == [
        {(4, HW, HW, True, True, True, 1): 1}, {(2, HW, HW, True, True, True, 1): 1}]
    for got in runs["got"]:
        for frames, (answer, got_served), (want_answer, served) in zip(
                (3, 1), got["session"], want):
            assert got_served == served
            assert answer.keys() == want_answer.keys()
            for key in want_answer:
                assert answer[key].shape == want_answer[key].shape
                assert key == "pose_enc_list" or answer[key].shape[0] == frames, key
                _close(answer[key], want_answer[key], f"session, {frames} frames, {key}")


def test_exact_mode_refuses_frames_that_do_not_divide(runs):
    """Exact mode cannot pad: 1 frame over 2 seq processes raises before a
    forward runs."""
    for got in runs["got"]:
        message, served = got["exact"]
        assert message is not None and "do not divide over the 2 seq processes" in message
        assert served == {}


def test_counted_collectives(runs):
    """One allgather forward (2 global layers, GT cameras and depth): the
    K and V gathers of every global layer, the cameras' gather, the camera
    tokens' and the four dense outputs', one depth sum. Logical seq ranks
    hold every frame and count none of them."""
    depth = TC.tiny_test_config().aggregator.depth
    ref_calls, ref_elems = runs["ref"]["forwards"][1]
    for got in runs["got"]:
        calls, elems = got["forwards"][1]
        assert calls == {"all_reduce": 0, "reduce_scatter": 0, "all_gather": 0,
                         "seq_all_gather": 2 * depth + 6, "seq_max": 0, "seq_sum": 1}
        assert ref_calls == {k: 0 for k in calls} and ref_elems == ref_calls
        assert elems["seq_sum"] == 2


def test_training_over_seq_processes_raises(runs):
    for got in runs["got"]:
        assert "next slice" in got["train"]
