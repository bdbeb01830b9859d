"""Fine-tuning from tar shards: the program's `make_train_step` on one
device, fed by its `ShardedSampleStream` and `batch_stream` (a prefetch
thread), as `tools/train.py --shards --batch B` runs it.

Set-up draws `scenes` samples from the seed in the layout of
`SceneDataset.sample`, writes them as tar shards of .npz members (the
program's shard format) under TMPDIR, builds the model from the seeded
weights, the layer-decay AdamW and the step, and runs the first
`checked_steps` steps through the same step and stream. The readings of
those steps are what the reference follows: each step's loss, the first
gradient as the optimizer took it (its first moment after one step over
1 - beta1), and each parameter's change after the last. The window runs
further steps until its seconds have passed, each timed from asking for
its batch to the end of its update.
"""

from __future__ import annotations

import io
import os
import sys
import shutil
import tarfile
import tempfile
import time

import numpy as np

from portbench import compare, flops, traffic_gen
from portbench.drivers import base

HEADS = ("camera_head", "depth_head", "point_head")
KEYS = ("images", "extrinsics", "intrinsics", "depth", "depth_valid", "world_points",
        "point_valid", "camera_mask", "depth_mask", "camera_valid")


def make_sample(pool, rng, S: int, size: int, cam_frames: int, depth_frames: int) -> dict:
    """A scene in SceneDataset.sample's layout; its depth and points carry
    a scale of their own, drawn log-uniform in [1/2, 2], as scenes do."""
    images, depth = pool.scene(rng, S)
    ex, K = traffic_gen.random_cameras(rng, S, size)
    scale = np.float32(np.exp(rng.uniform(np.log(0.5), np.log(2.0))))
    frames = np.arange(S)
    ones = np.ones((1, S, size, size), np.float32)
    return {
        "images": images[None], "extrinsics": ex[None], "intrinsics": K[None],
        "depth": depth[None] * scale, "depth_valid": ones,
        "world_points": rng.normal(size=(1, S, size, size, 3)).astype(np.float32) * scale,
        "point_valid": ones,
        "camera_mask": frames < cam_frames, "depth_mask": frames < depth_frames,
        "camera_valid": np.ones(S, bool),
    }


def write_tar_shards(samples, out_dir: str, per_shard: int):
    """Samples as tar files of .npz members sample-<n>.npz."""
    for s0 in range(0, len(samples), per_shard):
        with tarfile.open(os.path.join(out_dir, f"shard-{s0 // per_shard:06d}.tar"), "w") as tar:
            for n in range(s0, min(s0 + per_shard, len(samples))):
                buf = io.BytesIO()
                np.savez(buf, **samples[n])
                info = tarfile.TarInfo(name=f"sample-{n:09d}.npz")
                info.size = buf.tell()
                buf.seek(0)
                tar.addfile(info, buf)


def _print_step_times(records) -> None:
    """The window's step times on standard error: whether a slow run had a
    few long steps (the host stood still) or every step slower."""
    steps = np.array([(r["done"] - r["submit"]) / 1e9 for r in records])
    if not len(steps):
        return
    med = float(np.median(steps))
    long = steps[steps > 1.5 * med]
    print(f"portbench: {len(steps)} steps, seconds min {steps.min():.4f} median {med:.4f} "
          f"p90 {np.percentile(steps, 90):.4f} max {steps.max():.4f}; {len(long)} over 1.5x "
          f"the median, {float((long - med).sum()):.4f} s beyond it", file=sys.stderr)


class Driver(base.Driver):
    kind = "train"

    def setup(self):
        import torch

        from omnivggt_tpu_torch.data.streaming import ShardedSampleStream, batch_stream
        from omnivggt_tpu_torch.train.optim import make_finetune_optimizer
        from omnivggt_tpu_torch.train.step import init_state, make_train_step

        mix, size = self.mix, self.mix["image_size"]
        S = mix["views"]
        pool = traffic_gen.FramePool(self.seed, size, mix["pool_frames"])
        rng = np.random.default_rng([self.seed, 5 << 20])
        self.samples = [make_sample(pool, rng, S, size, mix["camera_frames"], mix["depth_frames"])
                        for _ in range(mix["scenes"])]
        self.tmp = tempfile.mkdtemp(prefix="portbench-shards-")
        write_tar_shards(self.samples, self.tmp, mix["samples_per_shard"])
        model, cfg = self.build_model()
        model.train()
        opt = mix["optimizer"]
        optimizer = make_finetune_optimizer(model, **opt)
        self.step = make_train_step(cfg, optimizer, use_aux_inputs=True, remat=mix["remat"],
                                    seed=self.seed)
        self.state = init_state(model, optimizer)
        stream = ShardedSampleStream(os.path.join(self.tmp, "shard-*.tar"), shard_rank=0,
                                     num_shards=1, shuffle_buffer=mix["shuffle_buffer"],
                                     seed=self.seed)
        self.batches = batch_stream(stream, mix["batch"])
        self.losses, self.fed, self.grad_norms = [], [], []
        beta1 = 0.9
        for k in range(mix["checked_steps"]):
            batch = next(self.batches)
            self.fed.append(self._identify(batch))
            metrics = self._step(batch)
            self.losses.append(float(metrics["total"]))
            self.grad_norms.append(float(metrics.get("grad_norm", float("nan"))))
            if k == 0:
                adam = optimizer.adamw.state
                self.grad1 = {n: float(adam[p]["exp_avg"].double().norm() / (1 - beta1))
                              if p in adam else float("inf")
                              for n, p in model.named_parameters()}
        from portbench.weights import make_state_dict

        init = make_state_dict(self.arch, self.seed, self.device)
        with torch.no_grad():
            self.change = {n: float((p.detach() - init[n]).double().norm())
                           for n, p in model.named_parameters()}
        del init
        self.sync()

    def _identify(self, batch) -> list:
        """Which of the set-up's samples the stream put in this batch."""
        keys = [s["extrinsics"][0].tobytes() for s in self.samples]
        return [keys.index(batch["extrinsics"][b].tobytes())
                for b in range(batch["extrinsics"].shape[0])]

    def _step(self, batch):
        from omnivggt_tpu_torch.train.step import batch_to_device

        step = self.step if self.fault is None else self.fault(self.step)
        self.state, metrics = step(self.state, batch_to_device(batch, self.device))
        return metrics

    def window(self, seconds: float, ctl) -> dict:
        import torch

        mix, size = self.mix, self.mix["image_size"]
        views = mix["batch"] * mix["views"]
        step_flops = 3 * mix["batch"] * flops.forward_flops(self.arch, mix["views"], size, size,
                                                            depth_gt=True)
        bound = mix["batch"] * flops.attention_bound_s(self.arch, mix["views"], size, size,
                                                       backward=True)
        records = []
        t0 = time.time_ns()
        t_end = t0 + int(seconds * 1e9)
        ctl.start()
        while True:
            t = time.time_ns()
            if t >= t_end:
                break
            with ctl.spans.span("data_wait"):
                batch = next(self.batches)
            t_data = time.time_ns()
            with ctl.spans.span("step"):
                self._step(batch)
                self.sync()
            records.append({"views": views, "submit": t, "done": time.time_ns(), "ok": True,
                            "data_wait_s": (t_data - t) / 1e9, "flops": step_flops,
                            "attn_bound_s": bound})
            ctl.between_steps()
        ctl.stop()
        _print_step_times(records)
        return {"t0": t0, "t_end": t_end, "requests": records}

    def free(self):
        self.batches.close()
        del self.state, self.step, self.batches
        shutil.rmtree(self.tmp, ignore_errors=True)

    def check(self, window: dict) -> dict:
        import torch

        from portbench.reference import train as RT

        mix, size = self.mix, self.mix["image_size"]
        ref = self.reference()
        ref.train()
        init = {n: p.detach().clone() for n, p in ref.named_parameters()}
        opt = RT.AdamW(ref, **mix["optimizer"])
        dev = self.device
        losses, grad1, ref_norms = [], None, []
        for k, ids in enumerate(self.fed):
            batch = {key: torch.as_tensor(np.stack([self.samples[i][key][0]
                                                    if self.samples[i][key].ndim > 1
                                                    else self.samples[i][key] for i in ids]),
                                          device=dev) for key in KEYS}
            ref.zero_grad(set_to_none=True)
            preds = ref(batch["images"], batch["extrinsics"], batch["intrinsics"],
                        batch["depth"], batch["depth_valid"], batch["camera_mask"].bool(),
                        batch["depth_mask"].bool(), checkpoint_blocks=True)
            total = RT.loss(preds, batch, (size, size))
            total.backward()
            del preds
            losses.append(float(total.detach()))
            grads = opt.step()
            ref_norms.append(float(opt.last_norm))
            if k == 0:
                grad1 = {n: float(g.double().norm()) for n, g in grads.items()}
            del grads
        change = {n: float((p.detach() - init[n]).double().norm())
                  for n, p in ref.named_parameters()}
        del ref, opt, init
        med = float(np.median(list(grad1.values())))
        moving = {n for n, v in grad1.items() if v >= 1e-3 * med}
        readings = {f"loss_step{k + 1}": abs(a - b) / abs(b)
                    for k, (a, b) in enumerate(zip(self.losses, losses))}
        heads = {n for n in grad1 if n.split(".")[0] in HEADS}
        dpt = {n for n in heads if not n.startswith("camera_head.")}
        readings["grad_heads"] = compare.by_leaf(self.grad1, grad1, keep=heads)
        readings["grad_dpt"] = compare.by_leaf(self.grad1, grad1, keep=dpt)
        readings["grad_dpt_mid"] = compare.median_leaf(self.grad1, grad1, keep=dpt)
        readings["grad_camera"] = compare.by_leaf(self.grad1, grad1, keep=heads - dpt)
        trunk = set(grad1) - heads
        attn = {n for n in trunk if ".attn." in n}
        readings["grad_trunk"] = compare.by_leaf(self.grad1, grad1, keep=trunk)
        readings["grad_trunk_mid"] = compare.median_leaf(self.grad1, grad1, keep=trunk)
        readings["grad_attn_mid"] = compare.median_leaf(self.grad1, grad1, keep=attn)
        # the gains of the trunk's q and k LayerNorms: their gradients come
        # from the attention backward's dQ and dK alone
        for x in ("q", "k"):
            gains = {n for n in attn if n.endswith(f".{x}_norm.weight")}
            readings[f"grad_{x}_norm_mid"] = compare.median_leaf(self.grad1, grad1, keep=gains)
        readings["grad_mid"] = compare.median_leaf(self.grad1, grad1, keep=moving)
        readings["update_leaf"] = compare.by_leaf(self.change, change, keep=moving)
        readings["update_mid"] = compare.median_leaf(self.change, change, keep=moving)
        for what, got, want, keep in (("first gradient", self.grad1, grad1, heads),
                                      ("change", self.change, change, moving)):
            worst = compare.worst_leaves(got, want, keep, 3)
            print(f"portbench: worst leaves of the {what}: "
                  + ", ".join(f"{n} {g:.3e} (program {got.get(n, 0):.6g}, reference "
                              f"{want.get(n, 0):.6g})" for g, n in worst), file=sys.stderr)
        print(f"portbench: leaves left out of the change (reference first gradient under 1e-3 "
              f"of the median leaf's): {sorted(set(grad1) - moving)}", file=sys.stderr)
        print(f"portbench: losses program {self.losses}, reference {losses}; gradient norms "
              f"program {self.grad_norms}, reference {ref_norms}", file=sys.stderr)
        return {"readings": readings, "checked": len(self.fed),
                "views_checked": len(self.fed) * mix["batch"] * mix["views"],
                "failed": 0, "attempted": len(window["requests"]),
                "left_out": sorted(set(grad1) - moving)}
