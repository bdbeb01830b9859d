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
  - the counted collectives of one step; zero2 / fsdp refused;
  - a (2, 2) mesh over four processes for one step against logical ranks;
  - the training CLI under torchrun on --mesh 1,2 against its logical run.

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
    """{what: the message} of the step's refusals on `mesh`."""
    out = {}
    for mode in ("zero2", "fsdp"):
        try:
            new_state(mesh, state_sharding=mode)
        except NotImplementedError as e:
            out[mode] = str(e)
    try:
        new_state(mesh, "ring_fused")
    except ValueError as e:
        out["ring_fused"] = str(e)
    return out


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
                   "refusals": refusals(mesh)}
    else:
        mesh = PM.make_mesh(data=2, seq=2, device="cpu")
        results = {"mesh": (mesh.rank, mesh.seq_rank),
                   "2x2": train(mesh, make_batch("first_camera_in_rank_1", scenes=2), steps=1)}
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


def test_zero2_and_fsdp_over_seq_processes_name_the_next_slice(runs):
    for got in runs["got"]:
        for mode in ("zero2", "fsdp"):
            assert "next slice" in got["refusals"][mode], mode
            assert f"state_sharding={mode!r}" in got["refusals"][mode]
        assert "ring kernels have no backward" in got["refusals"]["ring_fused"]


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


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_processes_train_to_the_jax_step(runs, strategy):
    """Both layouts' 2 steps over the processes against the JAX package's
    step on its (1, 2) mesh: metrics at rtol 2e-4 / atol 1e-6, the largest
    parameter at rtol 1e-4 / atol 2e-5."""
    want = _jax_run(strategy, {layout: make_batch(layout) for layout in sorted(LAYOUTS)})
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


def test_training_cli_under_torchrun_over_seq_processes(tmp_path):
    """torchrun --nproc_per_node 2 runs the training CLI on --mesh 1,2 on the
    CPU: the gloo group from torchrun's environment, one seq rank a
    process, both reading the same samples; global rank 0 alone logs (each
    step once) and writes the one checkpoint, and the logged losses equal
    the same CLI's run on 2 logical ranks within 1e-6."""
    from omnivggt_tpu_torch.data.streaming import write_shards

    samples = [{k: v.numpy() for k, v in TS.synthetic_batch(S, HW, "cpu", seed=i).items()}
               for i in range(4)]
    write_shards(samples, str(tmp_path / "shards"), samples_per_shard=2)
    args = ["--shards", str(tmp_path / "shards" / "*.tar"), "--batch", "1", "--views", str(S),
            "--tiny", "--device", "cpu", "--mesh", "1,2", "--steps", "2", "--warmup", "1",
            "--log_every", "1"]
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    logged = {}
    for launch in ("torchrun", "logical"):
        ck = tmp_path / launch
        cmd = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node", "2"] if launch == "torchrun" else [sys.executable])
        proc = subprocess.run(cmd + ["-m", "omnivggt_tpu_torch.tools.train", *args,
                                     "--ckpt_dir", str(ck)],
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
