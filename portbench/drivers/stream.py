"""A live video stream through the frame-causal model: one caller sending
one frame at a time to `OmniVGGT.stream_step`, in clips of a fixed length,
each frame's outputs on the card before the next frame is sent.

Set-up builds the model (VGGT-layout weights: the seeded state dict with
the camera adapters' biases and the depth placeholder at zero, for the
program and the reference alike), allocates the stream's cache for the
configuration's capacity once, and warms up with one short clip. The
window starts at a clip's first frame and closes at the end of the clip
running when its seconds have passed, so it counts whole clips only; the
cache is reset between clips and its buffers reused. Frames are seeded
choices from a `FramePool` on the card.

The program's own spans (`utils.profiling.recording()`: `model.stream_step`,
`model.trunk`, `model.camera_head`, `model.dpt_head`, `stream.cache_append`,
`stream.reset`) are recorded in a traced run, kept in the window's record
("program_spans") and join the harness's spans, so the trace gives each its
device time; the stream's readers take theirs from them (the DPT heads
replay a CUDA graph and are not called through the harness's wrapper). A
traced run starts the profiler at the first clip's frame
`trace_from_frame`, where the traced frames' attention is near the clip's
mean.

The check: the outputs of frames 0..t of the window's first clip, t drawn
from the seed in the traffic's range, kept on the card as returned, against
the plain reference's whole-clip forward over frames 0..t
(`reference/stream.py`), frame by frame. The window keeps the outputs up to
the range's top whatever t is, so its peak memory does not move with the
seed.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from portbench import compare, flops_stream, traffic_gen
from portbench.drivers import base

# the leaves a VGGT-layout checkpoint holds as zero in this model
ZEROED = ("aggregator.depth_placeholder",)
ZEROED_PREFIX, ZEROED_SUFFIX = "aggregator.camera_adapters.", ".bias"


def vggt_state_dict(arch: dict, seed: int, device) -> dict:
    """The seeded state dict (weights.make_state_dict) with the camera
    adapters' biases and the depth placeholder at zero, as a VGGT-layout
    checkpoint (StreamVGGT's) loads: with no GT input they add nothing."""
    from portbench.weights import make_state_dict

    sd = make_state_dict(arch, seed, device)
    for name, t in sd.items():
        if name in ZEROED or (name.startswith(ZEROED_PREFIX) and name.endswith(ZEROED_SUFFIX)):
            t.zero_()
    return sd


class Driver(base.Driver):
    kind = "infer"

    def build_model(self):
        import dataclasses

        from omnivggt_tpu_torch.models.omnivggt import OmniVGGT
        from omnivggt_tpu_torch.utils.validation import check_bounded_logits_safe

        cfg = self.program_cfg
        model = OmniVGGT(cfg, device=self.device, seed=None)
        sd = vggt_state_dict(self.arch, self.seed, self.device)
        model.load_state_dict(sd, strict=True)
        del sd
        if cfg.bounded_attn_logits and not check_bounded_logits_safe(
                model, cfg.embed_dim // cfg.aggregator.num_heads):
            cfg = dataclasses.replace(cfg, bounded_attn_logits=False)
        model.config = cfg
        return model.eval(), cfg

    def setup(self):
        import torch

        mix, size = self.mix, self.mix["image_size"]
        capacity = self.cell["config_data"]["stream"]["capacity"]
        if mix["clip_frames"] > capacity:
            raise SystemExit(f"clips of {mix['clip_frames']} frames exceed the configuration's "
                             f"capacity {capacity}")
        pool = traffic_gen.FramePool(self.seed, size, mix["pool_frames"])
        self.frames = torch.as_tensor(pool.images, device=self.device)
        del pool
        self.model, self.cfg = self.build_model()
        self.state = self.model.stream(capacity, (size, size))
        for idx in self.clip(-1)[:mix["warmup_frames"]]:
            self.model.stream_step(self.state, self.frames[idx])
        self.state.reset()
        self.sync()
        lo, self.keep_to = mix["check"]["frame_range"]
        self.check_at = int(self.rng.integers(lo, self.keep_to + 1))

    def clip(self, index: int) -> list:
        """The pool frames of clip `index` (-1: the warm-up's), in order."""
        rng = np.random.default_rng([self.seed, 5 << 20, index + 1])
        return rng.integers(len(self.frames), size=self.mix["clip_frames"]).tolist()

    def window(self, seconds: float, ctl) -> dict:
        import contextlib

        from omnivggt_tpu_torch.utils import profiling

        mix, size = self.mix, self.mix["image_size"]
        records, self.kept = [], []
        recording = profiling.recording() if ctl.traced else contextlib.nullcontext()
        with recording as rec:
            t0 = time.time_ns()
            t_end = t0 + int(seconds * 1e9)
            clip = 0
            while True:
                for t, idx in enumerate(self.clip(clip)):
                    if clip == 0 and t == mix["trace_from_frame"]:
                        ctl.start()
                    submit = time.time_ns()
                    out = self.model.stream_step(self.state, self.frames[idx])
                    self.sync()
                    records.append({"index": len(records), "clip": clip, "frame": t, "views": 1,
                                    "submit": submit, "done": time.time_ns(), "ok": True,
                                    "depth_gt": False})
                    if clip == 0 and t <= self.keep_to:  # as many whatever the seed
                        self.kept.append(out)
                    ctl.between_steps()
                self.state.reset()
                clip += 1
                if time.time_ns() >= t_end:
                    break
            ctl.stop()
        program_spans = rec.spans if rec is not None else []
        for s in program_spans:
            ctl.spans.add(s["name"], s["t0"], s["t1"], counts=s["counts"], hw=(size, size))
        for r in records:
            r["flops"] = flops_stream.step_flops(self.arch, r["frame"], size, size)
            r["attn_bound_s"] = flops_stream.attention_bound_s(self.arch, r["frame"], size, size)
        return {"t0": t0, "t_end": t_end, "requests": records, "clips": clip,
                "program_spans": program_spans}

    def free(self):
        del self.model, self.state

    def reference(self):
        import torch

        from portbench.reference.stream import StreamVGGT

        with torch.device("meta"):
            ref = StreamVGGT(self.arch)
        ref.to_empty(device=self.device)
        ref.load_state_dict(vggt_state_dict(self.arch, self.seed, self.device), strict=True)
        return ref.eval()

    def check(self, window: dict) -> dict:
        import torch

        readings = compare.Worst()
        kept, self.kept = self.kept[:self.check_at + 1], []
        frames = len(kept)
        if frames:
            got = {k: torch.cat([o[k][0] for o in kept]).float().cpu().numpy()
                   for k in kept[0] if k != "pose_enc_list"}
            del kept
            images = self.frames[self.clip(0)[:frames]][None]
            t0 = time.perf_counter()
            with torch.no_grad():
                want = self.reference()(images)
            want = {k: v[0].cpu().numpy() for k, v in want.items() if k != "pose_enc_list"}
            print(f"portbench: the reference's {frames} frames took "
                  f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
            readings.add(compare.dense(got, want))
        return {"readings": readings.values, "checked": int(frames > 0), "views_checked": frames,
                "failed": 0, "attempted": len(window["requests"])}
