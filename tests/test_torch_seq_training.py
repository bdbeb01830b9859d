"""Training with the seq axis over processes (train/step.py, train/losses.py,
parallel/collectives.py's seq_gather / seq_reduce_scatter /
seq_all_reduce_sum, models/aggregator.py's stochastic depth): gloo
processes, one seq rank each, against logical ranks in one process and
against the JAX package's train step on a (1, 2) mesh.

Two processes are spawned once for the module, and four once for the
(2, 2) case (file:// rendezvous in a temporary directory, every join and
init_process_group with a timeout). Each builds the tiny config from seed
0 and is given the whole batch (B=1, S=4, 28 px); it runs the frames of its
seq rank. The batches carry tests/test_torch_seq_processes.py's two GT
layouts: the first GT camera in seq rank 0's frames (1-3), or in seq rank
1's (2, 3), so the camera loss's rebase crosses the processes; depth GT and
valid pixels differ per frame, so a mean of the ranks' means is not the
scene's. Every run takes 2 steps of the layer-decay-free AdamW at warmup 1
(the first step's rate is 0, so the second moves the parameters from
gradients taken at the init).

  - losses, grad_norm and the final parameters equal the logical-rank step
    on make_mesh(data=1, seq=2) within tests/test_torch_distributed.py's
    _close (1e-6, and its Adam floor for the parameters), under "allgather"
    and "ring", both layouts, the camera loss without a frame mask, and
    stochastic depth;
  - the same against the JAX make_train_step on a JAX (1, 2) mesh: metrics
    at rtol 2e-4 / atol 1e-6, the largest parameter at rtol 1e-4 / atol
    2e-5 (tests/test_torch_fsdp.py's figures);
  - the parameters are bitwise equal across the processes after every run;
  - planted faults (the gather's backward keeping only this process's own
    gradient; the gradients left unsummed over the seq group) land far
    outside the tolerance;
  - the counted collectives of one step;
  - a (2, 2) mesh over four processes for one step against logical ranks;
  - zero2 and fsdp over the processes (the state in data x seq chunks, one
    a process; min_elems 0, as tests/test_fsdp.py sets _MIN_SHARD_ELEMS):
    the gradient chunks the optimizer is given are bitwise state none's
    summed gradient's; 2 steps against none and the JAX step; each
    process's chunk index and state bytes against the JAX package's
    NamedSharding and count, on (1, 2) and (2, 2); planted faults (the
    seq part of the reduce-scatter left out, the own chunk taken at the
    next index); a fsdp checkpoint gathered one tensor at a time, restored
    into a laid-out state;
  - the training CLI under torchrun on --mesh 1,2 against its logical run,
    under every state sharding.

The spawned processes import no JAX: the module imports it only inside the
tests that run here.
"""

import dataclasses
import hashlib
import json
import multiprocessing
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from omnivggt_tpu_torch import config as TC
from omnivggt_tpu_torch.models import omnivggt as TM
from omnivggt_tpu_torch.parallel import collectives as C
from omnivggt_tpu_torch.parallel import fsdp as TF
from omnivggt_tpu_torch.parallel import mesh as PM
from omnivggt_tpu_torch.parallel.sharding import ModelSharding
from omnivggt_tpu_torch.train import step as TS
from tests.test_torch_seq_processes import LAYOUTS

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
S, HW, STEPS, TOL = 4, 28, 2, 1e-6
ADAM_FLOOR = 5e-6  # tests/test_torch_distributed.py's floor for the parameters
STRATEGIES = ("allgather", "ring")
JOIN_S = 240
# (label, layout, strategy, drop_path, frame mask for the camera loss, steps)
CASES = tuple(
    (f"{layout} {strategy}", layout, strategy, 0.0, True, STEPS)
    for layout in sorted(LAYOUTS) for strategy in STRATEGIES
) + (
    ("drop_path", "first_camera_in_rank_1", "allgather", 0.2, True, STEPS),
    ("no camera mask", "first_camera_in_rank_1", "allgather", 0.0, False, 1),
)
FAULTS = ("own gradient only", "unsummed over seq")
SHARDED = ("zero2", "fsdp")
SHARDED_LAYOUT = "first_camera_in_rank_0"
SHARDED_FAULTS = ("seq part of the reduce-scatter left out", "own chunk at the next index")


def make_batch(layout, scenes=1, seed=0, camera_valid=True):
    """A training batch of `scenes` S=4 scenes at 28 px with the layout's GT:
    camera GT (the aux input and the loss's frame mask) on its camera
    frames, depth GT on its depth frames, per-frame valid-pixel densities."""
    cam, dep, density = LAYOUTS[layout]
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(scenes, S, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = np.moveaxis(q, -1, 0)
    R = np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
                  2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
                  2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
                 -1).reshape(scenes, S, 3, 3)
    K = np.zeros((scenes, S, 3, 3))
    K[..., 0, 0] = K[..., 1, 1] = 30.0
    K[..., 0, 2] = K[..., 1, 2] = HW / 2
    K[..., 2, 2] = 1.0
    dens = np.asarray(density)[None, :, None, None]
    batch = {
        "images": rng.uniform(size=(scenes, S, HW, HW, 3)).astype(np.float32),
        "extrinsics": np.concatenate([R, 3 * rng.normal(size=(scenes, S, 3, 1))], -1)
        .astype(np.float32),
        "intrinsics": K.astype(np.float32),
        "depth": rng.uniform(0.5, 5.0, size=(scenes, S, HW, HW, 1)).astype(np.float32),
        "depth_valid": (rng.uniform(size=(scenes, S, HW, HW)) < dens).astype(np.float32),
        "point_valid": (rng.uniform(size=(scenes, S, HW, HW)) < dens[:, ::-1]).astype(np.float32),
        "world_points": rng.normal(size=(scenes, S, HW, HW, 3)).astype(np.float32),
        "camera_mask": np.isin(np.arange(S), cam),
        "depth_mask": np.isin(np.arange(S), dep),
    }
    if camera_valid:
        batch["camera_valid"] = np.isin(np.arange(S), cam)
    return batch


def new_state(mesh, strategy="allgather", drop_path=0.0, state_sharding="none"):
    cfg = TC.tiny_test_config()
    if drop_path:
        cfg = dataclasses.replace(
            cfg, aggregator=dataclasses.replace(cfg.aggregator, drop_path_rate=drop_path))
    model = TM.OmniVGGT(cfg, device="cpu", seed=0).train()
    opt = TS.make_optimizer(model, learning_rate=1e-3, warmup_steps=1, total_steps=100)
    step = TS.make_train_step(cfg, opt, ModelSharding(mesh, strategy), use_aux_inputs=True,
                              remat=True, state_sharding=state_sharding)
    return TS.init_state(model, opt), step


def train(mesh, batch, strategy="allgather", drop_path=0.0, steps=STEPS, calls=False):
    """`steps` steps from the seed-0 init: ({metrics} a step, final parameters,
    and with `calls` the collectives of the first step)."""
    state, step = new_state(mesh, strategy, drop_path)
    batch = PM.shard_batch(mesh, batch)
    history, counted = [], None
    for i in range(steps):
        C.reset_calls()
        state, metrics = step(state, batch)
        if i == 0 and calls:
            counted = (C.calls(), C.elements())
        history.append({k: v.item() for k, v in metrics.items()})
    params = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    return history, params, counted


def run_cases(mesh):
    """Every CASES run on `mesh`, and the collectives of the first."""
    out = {}
    for i, (label, layout, strategy, drop_path, camera_valid, steps) in enumerate(CASES):
        out[label] = train(mesh, make_batch(layout, camera_valid=camera_valid), strategy,
                           drop_path, steps, calls=i == 0)
    return out


def planted(mesh, fault):
    """The first layout's allgather run with a planted fault."""
    if fault == "own gradient only":
        real = C._SeqGather.backward

        def own_only(ctx, grad):  # this process's own rows of its own gradient
            part = grad.shape[ctx.dim] // ctx.mesh.seq
            return grad.narrow(ctx.dim, ctx.mesh.seq_rank * part, part).contiguous(), None, None

        C._SeqGather.backward = staticmethod(own_only)
        try:
            return train(mesh, make_batch("first_camera_in_rank_0"))[:2]
        finally:
            C._SeqGather.backward = staticmethod(real)
    real = C.seq_all_reduce_sum
    C.seq_all_reduce_sum = lambda tensors, mesh, **kw: None
    try:
        return train(mesh, make_batch("first_camera_in_rank_0"))[:2]
    finally:
        C.seq_all_reduce_sum = real


def refusals(mesh):
    """{what: the message} of what training on `mesh` still refuses: the
    fused ring, and a zero2 / fsdp state laid out on another mesh (the
    same axes as logical ranks), which the step refuses before it reads
    the batch."""
    out = {}
    try:
        new_state(mesh, "ring_fused")
    except ValueError as e:
        out["ring_fused"] = str(e)
    for mode in SHARDED:
        state, step = new_state(mesh, state_sharding=mode)
        TF.shard_state(state, PM.Mesh(1, 2, mesh.device), mode, min_elems=0)
        try:
            step(state, {})
        except ValueError as e:
            out[mode] = str(e)
    return out


def new_sharded(mesh, mode):
    """new_state laid out under `mode` on `mesh` (min_elems 0: the tiny
    config's leaves are all below the default)."""
    state, step = new_state(mesh, state_sharding=mode)
    if mode != "none":
        TF.shard_state(state, mesh, mode, min_elems=0)
    return state, step


def capture_first_grads(state) -> dict:
    """{parameter name: the gradients the optimizer's first step is given,
    one a tensor it steps (a chunk of a sharded one)}, filled by it."""
    grads, real = {}, state.optimizer.step

    def first_step():
        state.optimizer.step = real
        grads.update({n: [t.grad.clone() for t in ts] for n, ts in state.optimizer.slots.items()})
        return real()

    state.optimizer.step = first_step
    return grads


def process_state_bytes(state) -> int:
    """The bytes this process holds of a TrainState: each parameter (its
    chunk under fsdp) and its two AdamW moments (their chunks under zero2
    and fsdp)."""
    layout, opt, total = state.layout, state.optimizer, 0
    for name, slots in opt.slots.items():
        param = (layout.params[name] if layout is not None and layout.mode == "zero2"
                 and name in layout.specs else slots[0])
        moments = opt.adamw.state[slots[0]]
        total += sum(t.numel() * t.element_size()
                     for t in (param, moments["exp_avg"], moments["exp_avg_sq"]))
    return total


def chunk_placement(state) -> tuple:
    """(name, sharded dim, [start, stop) along it) of the chunks this
    process holds of the largest sharded parameter: its layout's
    local_pieces of the dim's indices."""
    layout = state.layout
    name = max(layout.specs, key=lambda n: layout.shards[n][0].numel())
    dim, shard = layout.specs[name], layout.shards[name][0]
    shape = [1] * shard.ndim
    shape[dim] = shard.shape[dim] * layout.mesh.size
    pieces = layout.local_pieces(name, torch.arange(shape[dim]).view(shape))
    return name, dim, int(pieces[0].min()), int(pieces[-1].max()) + 1


def train_sharded(mesh, mode, batch, steps=STEPS):
    """`steps` steps of `mode` from the seed-0 init: (metrics a step, the
    final parameters whole, the first step's gradients, its collectives,
    the process's state bytes, its chunk of the largest sharded tensor)."""
    state, step = new_sharded(mesh, mode)
    grads = capture_first_grads(state)
    batch = PM.shard_batch(mesh, batch)
    history, counted = [], None
    for i in range(steps):
        C.reset_calls()
        state, metrics = step(state, batch)
        if i == 0:
            counted = C.calls()
        history.append({k: v.item() for k, v in metrics.items()})
    whole = state.layout.full_state_dict() if state.layout is not None else state.model.state_dict()
    params = {k: v.detach().clone() for k, v in whole.items()}
    out = {"history": history, "params": params, "grads": grads, "calls": counted}
    if state.layout is not None:
        out["bytes"] = process_state_bytes(state)
        out["placement"] = chunk_placement(state)
    return out


def sharded_planted(mesh, mode, fault):
    """train_sharded's metrics and final parameters under `mode` with a
    planted fault: the reduce-scatter keeping this process's part of its
    own gradient (the seq part left out), or every process holding and
    stepping the chunk at the next index."""
    batch = make_batch(SHARDED_LAYOUT)
    if fault == SHARDED_FAULTS[0]:
        real = C._seq_scatter_state

        def own_part_only(xs, mesh, dims, bucket_elems):
            return [x.narrow(d, mesh.seq_rank * (x.shape[d] // mesh.seq), x.shape[d] // mesh.seq)
                    .clone() for x, d in zip(xs, dims)]

        C._seq_scatter_state = own_part_only
        try:
            out = train_sharded(mesh, mode, batch)
        finally:
            C._seq_scatter_state = real
    else:
        real = PM.Mesh.own_ranks

        def next_index(m):
            first = (real.fget(m).start + 1) % m.size
            return range(first, first + m.local_size)

        PM.Mesh.own_ranks = property(next_index)
        try:
            out = train_sharded(mesh, mode, batch)
        finally:
            PM.Mesh.own_ranks = real
    return out["history"], out["params"]


def fsdp_save(mesh, out):
    """One fsdp step (at rate 0) over the processes, then its checkpoint:
    how many gathered tensors were alive at each gather of a save that
    drops them (every process gathers, global rank 0 writes), the file,
    and whether a fsdp state laid out first and restored from it holds the
    file's parameters and moments bitwise."""
    import weakref

    import torch.distributed as dist

    from omnivggt_tpu_torch.train import checkpointing as CK

    state, step = new_sharded(mesh, "fsdp")
    state, _ = step(state, PM.shard_batch(mesh, make_batch(SHARDED_LAYOUT)))
    gathered, alive, sound = [], [], C.all_gather

    def all_gather(*args, **kwargs):
        alive.append(sum(r() is not None for r in gathered))
        whole = sound(*args, **kwargs)
        gathered.append(weakref.ref(whole))
        return whole

    C.all_gather = all_gather
    try:
        state.layout.full_state_dict(lambda t: None)
        state.optimizer.state_dict(lambda t: None)
    finally:
        C.all_gather = sound
    path = CK.save_train_state(os.path.join(out, "ckpt_fsdp"), state)
    dist.barrier()  # the file is written
    like, _ = new_sharded(mesh, "fsdp")
    CK.restore_train_state(path, like)
    saved = torch.load(path, weights_only=True)
    model, moments = like.layout.full_state_dict(), like.optimizer.state_dict()["adamw"]["state"]
    roundtrip = (all(torch.equal(model[k], v) for k, v in saved["model"].items())
                 and all(torch.equal(moments[i][key], e[key])
                         for i, e in saved["optimizer"]["adamw"]["state"].items()
                         for key in ("exp_avg", "exp_avg_sq")))
    return {"path": path, "gathers": len(gathered), "alive": max(alive), "roundtrip": roundtrip,
            "step": like.step, "held": sum(s.numel() for ss in like.layout.shards.values()
                                           for s in ss)}


def digest(params):
    h = hashlib.sha256()
    for k in sorted(params):
        h.update(k.encode())
        h.update(params[k].numpy().tobytes())
    return h.hexdigest()


def _worker(rank, world, rdzv, out):
    torch.set_num_threads(1)
    import torch.distributed as dist

    PM.multihost_initialize(device="cpu", init_method=rdzv, world_size=world, rank=rank,
                            timeout=60)
    if world == 2:
        mesh = PM.make_mesh(data=1, seq=2, device="cpu")
        results = {"mesh": (mesh.seq_processes, mesh.seq_rank, mesh.group is None),
                   "cases": run_cases(mesh),
                   "faults": {f: planted(mesh, f) for f in FAULTS},
                   "refusals": refusals(mesh),
                   "sharded": {m: train_sharded(mesh, m, make_batch(SHARDED_LAYOUT))
                               for m in ("none",) + SHARDED},
                   "sharded_faults": {(m, f): sharded_planted(mesh, m, f)
                                      for m in SHARDED for f in SHARDED_FAULTS},
                   "fsdp_save": fsdp_save(mesh, out)}
    else:
        mesh = PM.make_mesh(data=2, seq=2, device="cpu")
        batch = make_batch("first_camera_in_rank_1", scenes=2)
        results = {"mesh": (mesh.rank, mesh.seq_rank),
                   "2x2": train(mesh, batch, steps=1),
                   "2x2 sharded": {m: train_sharded(mesh, m, batch, steps=1) for m in SHARDED}}
    torch.save(results, os.path.join(out, f"results_{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def _spawn(world, out):
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(r, world, f"file://{out}/rdzv", out))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs


def _join(procs, out):
    deadline = time.monotonic() + JOIN_S
    for p in procs:
        p.join(timeout=max(deadline - time.monotonic(), 1))
    alive = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(timeout=10)
    assert not alive, f"gloo processes {alive} did not finish in {JOIN_S} s"
    assert [p.exitcode for p in procs] == [0] * len(procs)
    return [torch.load(os.path.join(out, f"results_{r}.pt"), weights_only=False)
            for r in range(len(procs))]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two processes' results, and the same runs on logical ranks here."""
    out = str(tmp_path_factory.mktemp("seq_train"))
    procs = _spawn(2, out)
    logical = PM.make_mesh(data=1, seq=2, device="cpu")
    ref = {"cases": run_cases(logical)}
    return {"ref": ref, "got": _join(procs, out)}


@pytest.fixture(scope="module")
def runs_2x2(tmp_path_factory):
    """Four processes on a (2, 2) mesh, and the logical (2, 2) step here."""
    out = str(tmp_path_factory.mktemp("seq_train_2x2"))
    procs = _spawn(4, out)
    ref = train(PM.make_mesh(data=2, seq=2, device="cpu"),
                make_batch("first_camera_in_rank_1", scenes=2), steps=1)
    return {"ref": ref, "got": _join(procs, out)}


def _close(a, b, label, floor=0.0):
    np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL + floor, err_msg=label)


def _history_close(got, want, label):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            _close(g[k], w[k], f"{label} {k}")


def _params_close(got, want, label):
    assert got.keys() == want.keys()
    for k in want:
        _close(got[k].numpy(), want[k].numpy(), f"{label}: {k}", ADAM_FLOOR)


def _worst_relative(got, want):
    """The largest relative difference of two runs: metrics and parameters."""
    (gh, gp), (wh, wp) = got, want
    worst = max(abs(g[k] - w[k]) / abs(w[k]) for g, w in zip(gh, wh) for k in w)
    return max(worst, max(float(((gp[k] - wp[k]).abs().max() / wp[k].abs().max().clamp_min(1e-12)))
                          for k in wp))


def test_each_process_is_one_seq_rank(runs):
    for rank, got in enumerate(runs["got"]):
        assert got["mesh"] == (True, rank, True)


@pytest.mark.parametrize("label", [c[0] for c in CASES])
def test_processes_train_to_the_logical_ranks_numbers(runs, label):
    """Losses and grad_norm of every step, and the final parameters, equal
    the logical-rank step's; both processes report the same metrics and
    hold the same parameters bit for bit."""
    want_hist, want_params, _ = runs["ref"]["cases"][label]
    for got in runs["got"]:
        hist, params, _ = got["cases"][label]
        _history_close(hist, want_hist, label)
        _params_close(params, want_params, label)
    (h0, p0, _), (h1, p1, _) = (got["cases"][label] for got in runs["got"])
    assert h0 == h1
    assert digest(p0) == digest(p1)


def test_layouts_cross_the_processes(runs):
    """The first GT camera of each layout lives in the seq rank the layout
    names, and the two layouts train to different numbers."""
    assert min(LAYOUTS["first_camera_in_rank_0"][0]) < S // 2
    assert min(LAYOUTS["first_camera_in_rank_1"][0]) >= S // 2
    a = runs["ref"]["cases"]["first_camera_in_rank_0 allgather"][0][0]["camera"]
    b = runs["ref"]["cases"]["first_camera_in_rank_1 allgather"][0][0]["camera"]
    assert abs(a - b) > 100 * TOL


def test_stochastic_depth_draws_the_logical_ranks_masks(runs):
    """With drop_path 0.2 each process keeps its frames' rows of the whole
    batch's frame-block masks: its losses are the logical step's (the
    parametrised test above), and they differ from the step without."""
    dropped = runs["ref"]["cases"]["drop_path"][0]
    plain = runs["ref"]["cases"]["first_camera_in_rank_1 allgather"][0]
    assert all(abs(d["total"] - p["total"]) > 100 * TOL for d, p in zip(dropped, plain))


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_faults_leave_the_tolerance(runs, fault):
    """The gather's backward keeping only this process's own gradient (the
    parent's behaviour), or the gradients left unsummed over the seq group:
    the grad_norm or the parameters land far outside the tolerance."""
    label = "first_camera_in_rank_0 allgather"
    want_hist, want_params, _ = runs["ref"]["cases"][label]
    for got in runs["got"]:
        assert _worst_relative(got["faults"][fault], (want_hist, want_params)) > 1e3 * TOL


def test_counted_collectives(runs):
    """One allgather step (2 global layers, remat, GT cameras and depth):
    the K and V gathers of every global layer twice (the forward and its
    recomputation) and the camera tokens' once, differentiable; a reduce-
    scatter for each gather the graph keeps; the cameras' gathers (the
    pose encoding's and the loss's rebase); the depth mean's sum, the
    three counts' and the metrics'; one bucket of the gradients' sum. The
    logical ranks count no seq collective."""
    depth = TC.tiny_test_config().aggregator.depth
    _, params, (ref_calls, _) = runs["ref"]["cases"][CASES[0][0]]
    n_params = sum(v.numel() for v in params.values())
    for got in runs["got"]:
        calls, elems = got["cases"][CASES[0][0]][2]
        seq = {k: v for k, v in calls.items() if k.startswith("seq")}
        assert seq == {"seq_all_gather": 2, "seq_max": 0, "seq_sum": 5,
                       "seq_gather": 4 * depth + 1, "seq_reduce_scatter": 2 * depth + 1,
                       "seq_all_reduce": 1}
        assert elems["seq_all_reduce"] == n_params
        assert calls["reduce_scatter"] == calls["all_gather"] == 0
    assert all(v == 0 for k, v in ref_calls.items() if k.startswith("seq"))


def test_what_training_over_seq_processes_still_refuses(runs):
    """The fused ring (no backward), and a state laid out on another mesh
    than the step's; zero2 and fsdp themselves train (below)."""
    for got in runs["got"]:
        assert sorted(got["refusals"]) == ["fsdp", "ring_fused", "zero2"]
        assert "ring kernels have no backward" in got["refusals"]["ring_fused"]
        for mode in SHARDED:
            assert f"laid out for state_sharding={mode!r}" in got["refusals"][mode], mode
            assert f"this step is {mode!r}" in got["refusals"][mode], mode


def test_two_by_two_mesh_over_four_processes(runs_2x2):
    """data 2 x seq 2 over four processes: each its scene's frames of its
    seq rank; one step's metrics and parameters equal the logical (2, 2)
    step's, and all four processes hold the same parameters."""
    want_hist, want_params, _ = runs_2x2["ref"]
    digests = set()
    for rank, got in enumerate(runs_2x2["got"]):
        assert got["mesh"] == divmod(rank, 2)
        hist, params, _ = got["2x2"]
        _history_close(hist, want_hist, "2x2")
        _params_close(params, want_params, "2x2")
        digests.add(digest(params))
    assert len(digests) == 1


def _jax_run(strategy, batches):
    """The JAX make_train_step on a JAX (1, 2) mesh from the same weights:
    {name: (metrics a step, the final params in the port's names)}."""
    import jax
    import jax.numpy as jnp

    from omnivggt_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from omnivggt_tpu.parallel.mesh import shard_batch as jax_shard_batch
    from omnivggt_tpu.parallel.sharding import ModelSharding as JModelSharding
    from omnivggt_tpu.train import step as JS
    from omnivggt_tpu_torch.checkpoint import params_from_jax
    from tests import torch_port_util as U

    jcfg, tcfg, params, model = U.tiny_pair(seed=0)
    fresh = TM.OmniVGGT(tcfg, device="cpu", seed=0).state_dict()
    assert all(torch.equal(v, fresh[k]) for k, v in model.state_dict().items())
    opt = JS.make_optimizer(learning_rate=1e-3, warmup_steps=1, total_steps=100)
    jmesh = jax_make_mesh(data=1, seq=2, devices=jax.devices()[:2])
    step = JS.make_train_step(jcfg, opt, JModelSharding(jmesh, global_attn=strategy),
                              use_aux_inputs=True)
    out = {}
    for name, batch in batches.items():
        state = JS.init_state(jax.tree.map(jnp.asarray, params), opt)
        jb = jax_shard_batch(jmesh, {k: jnp.asarray(v) for k, v in batch.items()})
        history = []
        for _ in range(STEPS):
            state, m = step(state, jb)
            history.append({k: float(v) for k, v in m.items()})
        out[name] = (history, params_from_jax(U.to_np(state.params), tcfg))
    return out


@pytest.fixture(scope="module")
def jax_steps():
    """strategy -> _jax_run of both layouts, each compiled once for the module."""
    done = {}

    def get(strategy):
        if strategy not in done:
            done[strategy] = _jax_run(strategy, {layout: make_batch(layout)
                                                 for layout in sorted(LAYOUTS)})
        return done[strategy]

    return get


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_processes_train_to_the_jax_step(runs, jax_steps, strategy):
    """Both layouts' 2 steps over the processes against the JAX package's
    step on its (1, 2) mesh: metrics at rtol 2e-4 / atol 1e-6, the largest
    parameter at rtol 1e-4 / atol 2e-5."""
    want = jax_steps(strategy)
    for layout, (jhist, jparams) in want.items():
        hist, params, _ = runs["got"][1]["cases"][f"{layout} {strategy}"]
        for g, w in zip(hist, jhist):
            for key in w:
                np.testing.assert_allclose(g[key], w[key], rtol=2e-4, atol=1e-6,
                                           err_msg=f"{layout} {strategy} {key}")
        name = max(jparams, key=lambda k: jparams[k].numel())
        np.testing.assert_allclose(params[name].numpy(), jparams[name].numpy(), rtol=1e-4,
                                   atol=2e-5, err_msg=f"{layout} {strategy} {name}")


@pytest.mark.parametrize("mesh,world,backend", [
    ("1,2", 2, "gloo"), ("1,4", 4, "gloo"), ("1,2", 1, None), ("2,1", 2, None), ("2,2", 4, None),
    (None, 2, None)])
def test_cli_backend_under_torchrun(mesh, world, backend):
    """The CLI brings up a gloo group (on CUDA too) only for a seq-process
    mesh with data 1; a world of 1 with --mesh 1,2 is the data axis over
    one process (NCCL on the card), as phase (h) of chip_smoke.py runs it."""
    from omnivggt_tpu_torch.tools.train import launch_backend

    assert launch_backend(mesh, world) == backend


# the CLI with the tiny config's leaves sharded (as tests/test_fsdp.py sets
# _MIN_SHARD_ELEMS; they are all below the default threshold)
CLI_MAIN = """import sys
from omnivggt_tpu_torch.parallel import fsdp
fsdp._MIN_SHARD_ELEMS = 0
from omnivggt_tpu_torch.tools.train import main
main(sys.argv[1:])
"""


@pytest.mark.parametrize("state_sharding", ("none",) + SHARDED)
def test_training_cli_under_torchrun_over_seq_processes(tmp_path, state_sharding):
    """torchrun --nproc_per_node 2 runs the training CLI on --mesh 1,2 on the
    CPU under each --state_sharding: the gloo group from torchrun's
    environment, one seq rank a process, both reading the same samples;
    global rank 0 alone logs (each step once) and writes the one
    checkpoint, and the logged losses equal the same CLI's run on 2
    logical ranks within 1e-6."""
    from omnivggt_tpu_torch.data.streaming import write_shards

    samples = [{k: v.numpy() for k, v in TS.synthetic_batch(S, HW, "cpu", seed=i).items()}
               for i in range(4)]
    write_shards(samples, str(tmp_path / "shards"), samples_per_shard=2)
    (tmp_path / "cli_main.py").write_text(CLI_MAIN)
    args = ["--shards", str(tmp_path / "shards" / "*.tar"), "--batch", "1", "--views", str(S),
            "--tiny", "--device", "cpu", "--mesh", "1,2", "--steps", "2", "--warmup", "1",
            "--log_every", "1", "--state_sharding", state_sharding]
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    logged = {}
    for launch in ("torchrun", "logical"):
        ck = tmp_path / launch
        cmd = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node", "2"] if launch == "torchrun" else [sys.executable])
        proc = subprocess.run(cmd + [str(tmp_path / "cli_main.py"), *args, "--ckpt_dir", str(ck)],
                              cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240)
        assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
        logged[launch] = [json.loads(x) for x in (ck / "metrics.jsonl").read_text().splitlines()]
        assert [m["step"] for m in logged[launch]] == [1, 2]
        assert sorted(p.name for p in ck.iterdir()) == ["metrics.jsonl", "step_00000002.pt"]
        assert proc.stdout.count("saved ") == 1
        assert proc.stdout.count("step 2:") == 1
    for got, want in zip(logged["torchrun"], logged["logical"]):
        for key in ("total", "camera", "depth", "point", "grad_norm"):
            _close(got[key], want[key], f"CLI {key}")


def test_cli_lays_the_state_out_before_restoring(tmp_path, monkeypatch):
    """The training CLI resuming a fsdp run (2 logical seq ranks here) lays
    the state out first, so the restore loads each process's chunks into
    it and no state is whole on the way; the resumed step is logged."""
    from omnivggt_tpu_torch.data.streaming import write_shards
    from omnivggt_tpu_torch.tools import train as CLI
    from omnivggt_tpu_torch.train import checkpointing as CK

    samples = [{k: v.numpy() for k, v in TS.synthetic_batch(S, HW, "cpu", seed=i).items()}
               for i in range(2)]
    write_shards(samples, str(tmp_path / "shards"), samples_per_shard=2)
    monkeypatch.setattr(TF, "_MIN_SHARD_ELEMS", 0)
    args = ["--shards", str(tmp_path / "shards" / "*.tar"), "--batch", "1", "--views", str(S),
            "--tiny", "--device", "cpu", "--mesh", "1,2", "--state_sharding", "fsdp",
            "--warmup", "1", "--log_every", "1", "--ckpt_dir", str(tmp_path / "ck")]
    CLI.main(args + ["--steps", "1"])
    layouts, sound = [], CK.restore_train_state

    def restore(path, like):
        layouts.append((like.layout.mode, like.layout.mesh.shape, len(like.layout.shards)))
        return sound(path, like)

    monkeypatch.setattr(CK, "restore_train_state", restore)
    state = CLI.main(args + ["--steps", "2"])
    assert layouts == [("fsdp", {"data": 1, "seq": 2}, len(state.layout.specs))]
    assert len(state.layout.specs) > 0 and state.step == 2
    logged = [json.loads(x) for x in (tmp_path / "ck" / "metrics.jsonl").read_text().splitlines()]
    assert [m["step"] for m in logged] == [1, 2]


def _tiny_specs(ranks):
    model = TM.OmniVGGT(TC.tiny_test_config(), device="meta", seed=None)
    return {n: d for n, d in TF.tree_specs(model, ranks, 0).items() if d is not None}


@pytest.mark.parametrize("mode", SHARDED)
def test_sharded_gradient_chunks_are_state_nones_bitwise(runs, mode):
    """At data 1 the gradients the optimizer's first step is given over the
    two processes, under zero2 (reduce-scattered after the backward) and
    fsdp (in it), are bitwise the matching chunk of state none's summed
    gradient over the same processes: the same rank-order sum; the
    replicated leaves' are bitwise none's too."""
    specs = _tiny_specs(2)
    for rank, got in enumerate(runs["got"]):
        none, x = got["sharded"]["none"]["grads"], got["sharded"][mode]["grads"]
        assert none.keys() == x.keys() and len(specs) > 0.8 * len(none)
        for name, (whole,) in none.items():
            if name in specs:
                dim = specs[name]
                n = whole.shape[dim] // 2
                whole = whole.narrow(dim, rank * n, n)
            assert len(x[name]) == 1 and torch.equal(x[name][0], whole), (mode, rank, name)


@pytest.mark.parametrize("mode", SHARDED)
def test_sharded_modes_train_to_none_and_to_the_jax_step(runs, jax_steps, mode):
    """2 steps of zero2 / fsdp over the processes: metrics and parameters
    against state none over the same processes (1e-6, the Adam floor for
    the parameters), and against the JAX step on its (1, 2) mesh, whose
    zero2 / fsdp equal its none up to the reduction order, at
    tests/test_torch_fsdp.py's figures (metrics rtol 2e-4 / atol 1e-6; the
    largest parameter rtol 1e-4 / atol 2e-5; every one within 1e-4); both
    processes hold the same parameters bit for bit."""
    from tests import torch_port_util as U

    want_hist, want_params, _ = runs["got"][0]["cases"][f"{SHARDED_LAYOUT} allgather"]
    jhist, jparams = jax_steps("allgather")[SHARDED_LAYOUT]
    largest = max(jparams, key=lambda k: jparams[k].numel())
    digests = set()
    for got in runs["got"]:
        x = got["sharded"][mode]
        _history_close(x["history"], want_hist, mode)
        _params_close(x["params"], want_params, mode)
        for g, w in zip(x["history"], jhist):
            for key in w:
                np.testing.assert_allclose(g[key], w[key], rtol=2e-4, atol=1e-6,
                                           err_msg=f"{mode} {key}")
        np.testing.assert_allclose(x["params"][largest].numpy(), jparams[largest].numpy(),
                                   rtol=1e-4, atol=2e-5, err_msg=f"{mode} {largest}")
        U.assert_trees_close(x["params"], jparams, rel=0.0, floor=1e-4)
        digests.add(digest(x["params"]))
    assert len(digests) == 1


@pytest.mark.parametrize("data,seq", [(1, 2), (2, 2)])
def test_chunk_index_is_the_jax_named_shardings(request, data, seq):
    """Each process's chunk of the largest sharded tensor, under both modes,
    is the one that the JAX package's NamedSharding over ("data", "seq")
    places on device (data rank, seq rank) of a virtual CPU mesh."""
    import jax
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from omnivggt_tpu.parallel.mesh import make_mesh as jax_make_mesh

    jmesh = jax_make_mesh(data=data, seq=seq, devices=jax.devices()[:data * seq])
    if data == 1:
        got, key = request.getfixturevalue("runs")["got"], "sharded"
    else:
        got, key = request.getfixturevalue("runs_2x2")["got"], "2x2 sharded"
    for rank, res in enumerate(got):
        for mode in SHARDED:
            name, dim, start, stop = res[key][mode]["placement"]
            length = (stop - start) * data * seq
            where = NamedSharding(jmesh, P(("data", "seq"))).devices_indices_map((length,))
            index = where[jmesh.devices[divmod(rank, seq)]][0]
            assert (start, stop) == (index.start, index.stop), (mode, rank, name, dim)


@pytest.mark.parametrize("mode", SHARDED)
def test_state_bytes_a_process_are_the_jax_count(runs, runs_2x2, mode):
    """The bytes each process holds after a step (its parameters, or their
    chunks under fsdp, and their moments' chunks) equal
    state_bytes_per_device, which equals the JAX package's count on the
    same mesh (eval_shape; its two int32 step counts aside)."""
    import jax

    from omnivggt_tpu import config as JC
    from omnivggt_tpu.models import omnivggt as JM
    from omnivggt_tpu.parallel import fsdp as JF
    from omnivggt_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from omnivggt_tpu.train import step as JS

    shapes = jax.eval_shape(lambda: JS.init_state(JM.init(jax.random.PRNGKey(0),
                                                          JC.tiny_test_config()),
                                                  JS.make_optimizer()))
    model = TM.OmniVGGT(TC.tiny_test_config(), device="meta", seed=None)
    for (data, seq), got, key in (((1, 2), runs["got"], "sharded"),
                                  ((2, 2), runs_2x2["got"], "2x2 sharded")):
        jmesh = jax_make_mesh(data=data, seq=seq, devices=jax.devices()[:data * seq])
        want = JF.state_bytes_per_device(shapes, jmesh, mode, min_elems=0) - 8
        assert TF.state_bytes_per_device(model, PM.Mesh(data, seq, torch.device("meta")), mode,
                                         min_elems=0) == want
        for res in got:
            assert res[key][mode]["bytes"] == want, (data, seq, mode)


@pytest.mark.parametrize("mode", SHARDED)
@pytest.mark.parametrize("fault", SHARDED_FAULTS)
def test_sharded_planted_faults_leave_the_tolerance(runs, mode, fault):
    """The reduce-scatter keeping this process's part of its own gradient
    (the seq part left out), or every process holding the chunk at the
    next index: the metrics or the parameters land far outside the
    tolerance of state none's run."""
    want = runs["got"][0]["cases"][f"{SHARDED_LAYOUT} allgather"][:2]
    for got in runs["got"]:
        assert _worst_relative(got["sharded_faults"][(mode, fault)], want) > 1e3 * TOL


def test_fsdp_checkpoint_over_seq_processes(runs):
    """A fsdp save over the two processes after a step at rate 0 holds one
    gathered tensor at a time (none alive at the next gather), global rank
    0 alone writes it, its parameters are state none's after the same step
    bitwise, and a fsdp state laid out first restores from it bitwise,
    each process holding its half of the sharded tensors."""
    saves = [got["fsdp_save"] for got in runs["got"]]
    path = saves[0]["path"]
    assert all(x["path"] == path for x in saves) and os.listdir(os.path.dirname(path)) == [
        os.path.basename(path)]
    _, want, _ = train(PM.make_mesh(data=1, seq=2, device="cpu"), make_batch(SHARDED_LAYOUT),
                       steps=1)
    saved = torch.load(path, weights_only=True)["model"]
    assert saved.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(saved[k], v), k
    specs = _tiny_specs(2)
    sharded = sum(v.numel() for k, v in want.items() if k in specs)
    for x in saves:
        assert x["alive"] == 0 and x["gathers"] >= 3 * len(specs)
        assert x["roundtrip"] and x["step"] == 1 and 2 * x["held"] == sharded


@pytest.mark.parametrize("mode", SHARDED)
def test_sharded_counted_collectives(runs, mode):
    """One step's collectives a process: state none's seq collectives and
    one more seq_sum (the shards' squares of the global norm), the
    replicated gradients' sum in one bucket, a reduce-scatter counted for
    every sharded tensor. zero2: after the backward one flat bucket of
    reduce-scatters and, after the update, one of gathers; fsdp: one flat
    gather a block (twice for the aggregator's: remat), one for the camera
    head's call (its trunk runs once an iteration) and one for the rest,
    and a flat reduce-scatter for each gather the graph keeps."""
    cfg = TC.tiny_test_config()
    depth, n_sharded = cfg.aggregator.depth, len(_tiny_specs(2))
    blocks = 2 * depth  # frame and global; the tiny config's patch embed is a conv
    assert cfg.aggregator.patch_embed == "conv"
    for got in runs["got"]:
        calls = got["sharded"][mode]["calls"]
        assert {k: v for k, v in calls.items() if k.startswith("seq")} == {
            "seq_all_gather": 2, "seq_max": 0, "seq_sum": 6, "seq_gather": 4 * depth + 1,
            "seq_reduce_scatter": 2 * depth + 1, "seq_all_reduce": 1}
        assert calls["reduce_scatter"] == n_sharded
        if mode == "zero2":
            assert calls["all_gather"] == n_sharded
            assert calls["state_seq_gather"] == calls["state_seq_scatter"] == 1
        else:
            assert calls["all_gather"] > n_sharded
            assert calls["state_seq_gather"] == 2 * blocks + 2
            assert calls["state_seq_scatter"] == blocks + 2


@pytest.mark.parametrize("mode", SHARDED)
def test_sharded_two_by_two_mesh_over_four_processes(runs_2x2, mode):
    """zero2 / fsdp on data 2 x seq 2 over four processes, one chunk each:
    one step's metrics and parameters equal the logical (2, 2) step's at
    state none, and all four processes hold the same parameters."""
    want_hist, want_params, _ = runs_2x2["ref"]
    digests = set()
    for got in runs_2x2["got"]:
        x = got["2x2 sharded"][mode]
        _history_close(x["history"], want_hist, f"2x2 {mode}")
        _params_close(x["params"], want_params, f"2x2 {mode}")
        digests.add(digest(x["params"]))
    assert len(digests) == 1
