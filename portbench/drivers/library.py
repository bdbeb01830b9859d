"""Scenes through the library: one client calling `OmniVGGT.forward` under
inference mode, one scene after another, inputs and outputs on the card.

Set-up draws `scenes` distinct scenes from the seed and places them on the
device; the window cycles through them, waiting for each scene's outputs
before sending the next. The window closes with the first answer after
its seconds have passed.
"""

from __future__ import annotations

import time

import numpy as np

from portbench import compare, flops, traffic_gen
from portbench.drivers import base


class Driver(base.Driver):
    kind = "infer"

    def setup(self):
        import torch

        mix, size = self.mix, self.mix["image_size"]
        pool = traffic_gen.FramePool(self.seed, size, mix["pool_frames"])
        self.model, self.cfg = self.build_model()
        self.model.eval()
        S, dev = mix["views"], self.device
        self.scenes = []
        for i in range(mix["scenes"]):
            rng = np.random.default_rng([self.seed, 4 << 20, i])
            images, _ = pool.scene(rng, S)
            ex, K = traffic_gen.random_cameras(rng, S, size)
            cams = sorted(rng.choice(S, size=mix["camera_frames"], replace=False).tolist())
            self.scenes.append({
                "images": torch.as_tensor(images, device=dev)[None],
                "extrinsics": torch.as_tensor(ex, device=dev)[None],
                "intrinsics": torch.as_tensor(K, device=dev)[None],
                "camera_gt_index": cams,
            })
        for _ in range(mix["warmup"]):
            self.forward(self.scenes[0])
        self.sync()
        self.check_at = int(self.rng.integers(mix["check"]["among_first"]))

    def forward(self, scene):
        import torch

        with torch.inference_mode():
            return self.model(scene["images"], extrinsics=scene["extrinsics"],
                              intrinsics=scene["intrinsics"],
                              camera_gt_index=scene["camera_gt_index"])

    def window(self, seconds: float, ctl) -> dict:
        import torch

        records, self.kept = [], None
        t0 = time.time_ns()
        t_end = t0 + int(seconds * 1e9)
        ctl.start()
        i = 0
        while True:
            t = time.time_ns()
            if t >= t_end:
                break
            scene = self.scenes[i % len(self.scenes)]
            out = self.forward(scene)
            self.sync()
            records.append({"index": i, "views": self.mix["views"], "submit": t,
                            "done": time.time_ns(), "ok": True, "depth_gt": False})
            if i == self.check_at:
                self.kept = (i, out)
            i += 1
            ctl.between_steps()
        ctl.stop()
        size = self.mix["image_size"]
        for r in records:
            r["flops"] = flops.forward_flops(self.arch, r["views"], size, size)
            r["attn_bound_s"] = flops.attention_bound_s(self.arch, r["views"], size, size)
        return {"t0": t0, "t_end": t_end, "requests": records}

    def free(self):
        del self.model

    def check(self, window: dict) -> dict:
        import torch

        readings = compare.Worst()
        checked = 0
        if self.kept is not None:
            i, out = self.kept
            scene = self.scenes[i % len(self.scenes)]
            got = {k: v[0].float().cpu().numpy() for k, v in out.items() if k != "pose_enc_list"}
            self.kept = None
            del out
            S = self.mix["views"]
            cam = torch.zeros(1, S, dtype=torch.bool, device=self.device)
            cam[0, scene["camera_gt_index"]] = True
            ref = self.reference()
            with torch.no_grad():
                want = ref(scene["images"], scene["extrinsics"], scene["intrinsics"],
                           camera_mask=cam)
            want = {k: v[0].cpu().numpy() for k, v in want.items() if k != "pose_enc_list"}
            readings.add(compare.dense(got, want))
            checked = 1
        return {"readings": readings.values, "checked": checked,
                "views_checked": checked * self.mix["views"], "failed": 0,
                "attempted": len(window["requests"])}
