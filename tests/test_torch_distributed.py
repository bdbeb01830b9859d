"""The data axis over processes (parallel/mesh.py, parallel/collectives.py,
parallel/fsdp.py, train/step.py): two gloo processes against logical ranks
in one process.

Two processes are spawned once for the module (file:// rendezvous in a
temporary directory, every join and init_process_group with a timeout).
Each takes one scene of a B=2 batch (mesh (2, 2): the data axis over the
processes, two logical seq ranks in each) and runs 3 train steps of the
tiny config under "none", "zero2" and "fsdp"; the same steps run here on a
logical (2, 2) mesh. The two scenes have unequal valid-pixel counts and
camera masks, so a mean of the ranks' means differs from the global loss.
Losses, grad_norm and the moments agree within 1e-6 (relative and
absolute: fp32 sums over the scenes in another order), the final
parameters within 1e-6 and ADAM_FLOOR. The counters show which collective
carried each gradient sync. Checkpoints cross layouts: written sharded by
the processes, restored unsharded here, and the other way round.

This module imports no JAX: the spawned processes import it.
"""

import json
import multiprocessing
import os
import socket
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
from omnivggt_tpu_torch.parallel import fsdp
from omnivggt_tpu_torch.parallel import mesh as PM
from omnivggt_tpu_torch.parallel.sharding import ModelSharding
from omnivggt_tpu_torch.train import checkpointing as TCK
from omnivggt_tpu_torch.train import losses as TLS
from omnivggt_tpu_torch.train import step as TS

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
MODES = ("none", "zero2", "fsdp")
B, S, HW, STEPS, TOL = 2, 4, 28, 3, 1e-6
# Adam divides each element's gradient by its own running magnitude, so an
# element whose gradient is near zero moves by a step that the fp32 sums'
# order can change: the parameters get 0.5% of one 1e-3 learning-rate step
# on top of TOL (2.5e-6 read on 3 of 37632 elements of the patch embedding)
ADAM_FLOOR = 5e-6
JOIN_S = 240


def make_batch(seed=0):
    """B=2 scenes whose valid pixels (90% and 30%), camera GT and camera
    masks differ per scene."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = np.moveaxis(q, -1, 0)
    R = np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
                  2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
                  2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
                 -1).reshape(B, S, 3, 3)
    K = np.zeros((B, S, 3, 3))
    K[..., 0, 0] = K[..., 1, 1] = 30.0
    K[..., 0, 2] = K[..., 1, 2] = HW / 2
    K[..., 2, 2] = 1.0
    density = np.array([0.9, 0.3])[:, None, None, None]
    return {
        "images": rng.uniform(size=(B, S, HW, HW, 3)).astype(np.float32),
        "extrinsics": np.concatenate([R, rng.normal(size=(B, S, 3, 1))], -1).astype(np.float32),
        "intrinsics": K.astype(np.float32),
        "depth": rng.uniform(0.5, 5.0, size=(B, S, HW, HW, 1)).astype(np.float32),
        "depth_valid": (rng.uniform(size=(B, S, HW, HW)) < density).astype(np.float32),
        "point_valid": (rng.uniform(size=(B, S, HW, HW)) < density[::-1]).astype(np.float32),
        "world_points": rng.normal(size=(B, S, HW, HW, 3)).astype(np.float32),
        "camera_valid": np.array([[True, True, True, False], [True, False, False, False]]),
        "camera_mask": np.array([[True, False, True, False], [False, True, False, False]]),
        "depth_mask": np.array([[True, True, False, False], [True, False, False, True]]),
    }


def make_state(mode, mesh):
    """The tiny model from seed 0, its optimizer, laid out under `mode`,
    and the sharded train step. "drop_path": "none" with stochastic depth
    at 0.2."""
    import dataclasses

    cfg = TC.tiny_test_config()
    if mode == "drop_path":
        mode = "none"
        cfg = dataclasses.replace(
            cfg, aggregator=dataclasses.replace(cfg.aggregator, drop_path_rate=0.2))
    model = TM.OmniVGGT(cfg, device=mesh.device, seed=0).train()
    opt = TS.make_optimizer(model, learning_rate=1e-3, warmup_steps=1, total_steps=100)
    # min_elems 0: the tiny config's leaves are all below the default
    state = fsdp.shard_state(TS.init_state(model, opt), mesh, mode, min_elems=0)
    step = TS.make_train_step(cfg, opt, ModelSharding(mesh, "allgather"), use_aux_inputs=True,
                              remat=True, state_sharding=mode)
    return state, step


def run_steps(state, step, batch, n):
    history = []
    for _ in range(n):
        state, metrics = step(state, batch)
        history.append({k: v.item() for k, v in metrics.items()})
    return history


def full_state(state):
    model = state.layout.full_state_dict() if state.layout is not None else state.model.state_dict()
    return {k: v.detach().clone() for k, v in model.items()}, state.optimizer.state_dict()


def _worker(rank, rdzv, out):
    """One process of the two: every mode's steps, a checkpoint of each,
    and a step from the checkpoint written by logical ranks."""
    torch.set_num_threads(1)
    import torch.distributed as dist

    PM.multihost_initialize(device="cpu", init_method=rdzv, world_size=2, rank=rank, timeout=60)
    # a second call is tolerated and keeps the group
    PM.multihost_initialize(device="cpu", init_method=rdzv, world_size=2, rank=rank, timeout=60)
    mesh = PM.make_mesh(data=2, seq=2, device="cpu")
    batch = PM.shard_batch(mesh, dict(np.load(os.path.join(out, "batch.npz"))))
    results = {"mesh": (mesh.rank, mesh.local_shape, tuple(batch["images"].shape))}
    state, step = make_state("drop_path", mesh)
    results["drop_path"] = run_steps(state, step, batch, 2)
    for mode in MODES:
        state, step = make_state(mode, mesh)
        C.reset_calls()
        run_steps(state, step, batch, 1)
        calls = (C.calls(), C.elements())
        history = run_steps(state, step, batch, STEPS - 1)
        # each process names its own directory: only data rank 0's may fill
        path = TCK.save_train_state(os.path.join(out, f"ckpt_{mode}_{rank}"), state)
        results[mode] = {"calls": calls, "history": history, "state": full_state(state),
                         "path": path}
        state, step = make_state(mode, mesh)
        TCK.restore_train_state(TCK.latest_checkpoint(os.path.join(out, "ckpt_logical")), state)
        results[mode]["from_logical"] = (run_steps(state, step, batch, 1), full_state(state))
    torch.save(results, os.path.join(out, f"results_{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both processes' results, and the same steps on logical ranks here."""
    out = str(tmp_path_factory.mktemp("dist"))
    batch = make_batch()
    np.savez(os.path.join(out, "batch.npz"), **batch)
    logical = PM.make_mesh(data=2, seq=2, device="cpu")
    tb = PM.shard_batch(logical, batch)
    state, step = make_state("none", logical)
    run_steps(state, step, tb, 1)
    TCK.save_train_state(os.path.join(out, "ckpt_logical"), state)

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(r, f"file://{out}/rdzv", out)) for r in (0, 1)]
    for p in procs:
        p.start()
    state, step = make_state("drop_path", logical)
    ref = {"drop_path": run_steps(state, step, tb, 2)}
    for mode in MODES:  # the logical-rank steps run while the processes start
        state, step = make_state(mode, logical)
        C.reset_calls()
        run_steps(state, step, tb, 1)
        calls = (C.calls(), C.elements())
        history = run_steps(state, step, tb, STEPS - 1)
        ref[mode] = {"calls": calls, "history": history, "state": full_state(state)}
        state, step = make_state(mode, logical)
        TCK.restore_train_state(TCK.latest_checkpoint(os.path.join(out, "ckpt_logical")), state)
        ref[mode]["from_logical"] = (run_steps(state, step, tb, 1), full_state(state))
    deadline = time.monotonic() + JOIN_S
    for p in procs:
        p.join(timeout=max(deadline - time.monotonic(), 1))
    alive = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(timeout=10)
    assert not alive, f"gloo processes {alive} did not finish in {JOIN_S} s"
    assert [p.exitcode for p in procs] == [0, 0]
    got = [torch.load(os.path.join(out, f"results_{r}.pt"), weights_only=False) for r in (0, 1)]
    return {"out": out, "batch": batch, "ref": ref, "got": got}


def _close(a, b, label, floor=0.0):
    np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL + floor, err_msg=label)


def _states_close(got, want, label):
    (gp, go), (wp, wo) = got, want
    assert gp.keys() == wp.keys()
    for k in wp:
        _close(gp[k].numpy(), wp[k].numpy(), f"{label}: {k}", ADAM_FLOOR)
    assert go["count"] == wo["count"]
    gs, ws = go["adamw"]["state"], wo["adamw"]["state"]
    assert gs.keys() == ws.keys()
    for i in ws:
        for key in ("exp_avg", "exp_avg_sq"):
            _close(gs[i][key].numpy(), ws[i][key].numpy(), f"{label}: moment {i} {key}")


def test_each_process_holds_its_scene_and_its_seq_ranks(runs):
    for rank, got in enumerate(runs["got"]):
        assert got["mesh"] == (rank, {"data": 1, "seq": 2}, (1, S, HW, HW, 3))


def test_mean_of_the_ranks_means_is_not_the_global_loss(runs):
    """The batch's scenes weigh differently: the global loss (the logical
    step's first) is not the mean of each scene's own loss."""
    tb = TS.batch_to_device(runs["batch"], "cpu")
    model = TM.OmniVGGT(TC.tiny_test_config(), device="cpu", seed=0)
    with torch.no_grad():
        preds = TM.apply(model, tb["images"], model.config, pad_tokens=False)
        whole = TLS.total_loss(preds, tb, (HW, HW))["total"].item()
        own = [TLS.total_loss({k: v[:, i:i + 1] if k == "pose_enc_list" else v[i:i + 1]
                               for k, v in preds.items()},
                              {k: v[i:i + 1] for k, v in tb.items()}, (HW, HW))["total"].item()
               for i in range(B)]
    assert abs(np.mean(own) - whole) > 100 * TOL


@pytest.mark.parametrize("mode", MODES)
def test_processes_match_logical_ranks(runs, mode):
    """Losses and grad_norm of every step, and the final parameters and
    moments (gathered), equal the logical-rank step's within 1e-6; both
    processes report the same global metrics."""
    want = runs["ref"][mode]
    for got in runs["got"]:
        for g, w in zip(got[mode]["history"], want["history"]):
            assert g.keys() == w.keys()
            for k in w:
                _close(g[k], w[k], f"{mode} {k}")
        _states_close(got[mode]["state"], want["state"], mode)


def test_stochastic_depth_draws_the_logical_ranks_masks(runs):
    """With drop_path 0.2 each process keeps its scenes' rows of the whole
    batch's keep masks: the losses equal the logical step's, and differ
    from the step without stochastic depth."""
    for got in runs["got"]:
        for g, w in zip(got["drop_path"], runs["ref"]["drop_path"]):
            for k in w:
                _close(g[k], w[k], f"drop_path {k}")
    assert runs["ref"]["drop_path"][1]["total"] != runs["ref"]["none"]["history"][0]["total"]


@pytest.mark.parametrize("mode", MODES)
def test_gradient_sync_collectives(runs, mode):
    """One step's collectives: under "none" every gradient is all-reduced;
    zero2's sharded gradients are reduce-scattered and not all-reduced (the
    all-reduce carries only the replicated leaves, the loss's counts and
    metrics and the norm); fsdp gathers its parameters in the forward and
    reduce-scatters in the backward. Logical ranks count the same calls."""
    n_params = sum(v.numel() for v in runs["ref"]["none"]["state"][0].values())
    calls, elems = runs["got"][0][mode]["calls"]
    assert (calls, elems) == runs["ref"][mode]["calls"]
    if mode == "none":
        assert calls["reduce_scatter"] == calls["all_gather"] == 0
        assert elems["all_reduce"] >= n_params
    else:
        assert elems["reduce_scatter"] >= 0.9 * n_params
        assert elems["all_reduce"] < 0.1 * n_params
        assert calls["all_gather"] > 0
    if mode == "fsdp":  # the forward's gathers, and remat's again
        assert calls["all_gather"] > calls["reduce_scatter"]


def test_rank_zero_alone_writes_and_sharded_checkpoints_restore_unsharded(runs):
    """Each process's checkpoint call returns the path, data rank 0 writes
    it; restored into an unsharded state here, the parameters and moments
    are the processes' gathered ones, bitwise."""
    for mode in MODES:
        path = TCK.latest_checkpoint(os.path.join(runs["out"], f"ckpt_{mode}_0"))
        assert path == runs["got"][0][mode]["path"] and path.endswith(f"step_{STEPS:08d}.pt")
        assert runs["got"][1][mode]["path"].endswith(f"step_{STEPS:08d}.pt")
        assert not os.path.exists(os.path.join(runs["out"], f"ckpt_{mode}_1"))
        state, _ = make_state("none", PM.make_mesh(data=2, seq=2, device="cpu"))
        TCK.restore_train_state(path, state)
        assert state.step == STEPS and state.optimizer.count == STEPS
        params, opt = full_state(state)
        gp, go = runs["got"][0][mode]["state"]
        for k in gp:
            assert torch.equal(params[k], gp[k]), (mode, k)
        for i, entry in go["adamw"]["state"].items():
            for key in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(opt["adamw"]["state"][i][key], entry[key]), (mode, i, key)


@pytest.mark.parametrize("mode", MODES)
def test_unsharded_checkpoint_restores_sharded(runs, mode):
    """The checkpoint written by logical ranks after one step, restored into
    each process's sharded state: the next step equals the logical one."""
    (got_hist, got_state), (want_hist, want_state) = (
        runs["got"][0][mode]["from_logical"], runs["ref"][mode]["from_logical"])
    for k in want_hist[0]:
        _close(got_hist[0][k], want_hist[0][k], f"{mode} {k}")
    _states_close(got_state, want_state, mode)


def test_multihost_initialize_fails_fast_on_an_unreachable_address():
    """Nothing listens at the address: the rendezvous raises within its
    timeout and leaves no group behind."""
    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.monotonic()
    with pytest.raises((RuntimeError, TimeoutError)):
        PM.multihost_initialize(device="cpu", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=2, rank=1, timeout=2)
    assert time.monotonic() - t0 < 30
    assert not dist.is_initialized()


def test_training_cli_under_torchrun_on_two_processes(tmp_path):
    """torchrun --nproc_per_node 2 runs the training CLI on the CPU: the
    process group from torchrun's environment, --batch 2 as one scene a
    process from its own shard, zero2 over a (2, 1) mesh; rank 0 alone logs
    (each step once) and writes the one checkpoint."""
    from omnivggt_tpu_torch.data.streaming import write_shards

    samples = [{k: v.numpy() for k, v in TS.synthetic_batch(2, HW, "cpu", seed=i).items()}
               for i in range(4)]
    write_shards(samples, str(tmp_path / "shards"), samples_per_shard=2)
    ck = tmp_path / "run"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
           "-m", "omnivggt_tpu_torch.tools.train", "--shards", str(tmp_path / "shards" / "*.tar"),
           "--batch", "2", "--views", "2", "--tiny", "--device", "cpu", "--mesh", "2,1",
           "--state_sharding", "zero2", "--steps", "2", "--warmup", "1", "--log_every", "1",
           "--ckpt_dir", str(ck)]
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    proc = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    logged = [json.loads(x) for x in (ck / "metrics.jsonl").read_text().splitlines()]
    assert [m["step"] for m in logged] == [1, 2]
    assert all(np.isfinite(m["total"]) and m["grad_norm"] > 0 for m in logged)
    assert sorted(p.name for p in ck.iterdir()) == ["metrics.jsonl", "step_00000002.pt"]
    assert proc.stdout.count("saved ") == 1
