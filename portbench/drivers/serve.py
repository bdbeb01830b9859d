"""Served scenes: a closed loop of client threads calling the program's
`Batcher.submit` over one `InferenceSession`.

Each client takes the next request of the mix (traffic_gen.plan, cycle
after cycle), submits it and waits for its answer. The window opens with
the clients; a client sends nothing once the window's seconds have passed,
and the window closes when every request sent has been answered. A
request's latency runs from submit to answer.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from portbench import compare, flops, traffic_gen
from portbench.drivers import base


class Driver(base.Driver):
    kind = "infer"

    def setup(self):
        import torch

        from omnivggt_tpu_torch import serving

        mix, size = self.mix, self.mix["image_size"]
        self.pool = traffic_gen.FramePool(self.seed, size, mix["pool_frames"])
        self.model, self.cfg = self.build_model()
        self.session = serving.InferenceSession(self.model)  # the default buckets
        # every bucket the mix reaches, exact and masked, in every layout
        sizes = sorted({item["views"] for c in range(2) for item in self.plan(c)})
        layouts = sorted({(m["camera"] > 0, m["depth"] > 0) for m in mix["modalities"]})
        self.session.warmup(frame_counts=sizes, hw=(size, size), modalities=layouts)
        self.batcher = serving.Batcher(self.session, max_batch=mix["max_batch"],
                                       window_ms=mix["window_ms"])
        self.sync()
        self.keep = set(self.rng.choice(4 * mix["cycle"], size=4 * mix["check"]["sample"],
                                        replace=False).tolist())

    def plan(self, cycle: int):
        return traffic_gen.plan(self.mix, self.seed, cycle)

    def item(self, index: int) -> dict:
        n = self.mix["cycle"]
        return self.plan(index // n)[index % n]

    def window(self, seconds: float, ctl) -> dict:
        mix = self.mix
        lock = threading.Lock()
        counter = iter(range(1 << 30))
        records, kept, largest = [], {}, [0, None, None, None]
        t0 = time.time_ns()
        t_end = t0 + int(seconds * 1e9)

        def client():
            while True:
                with lock:
                    index = next(counter)
                    item = self.item(index)
                req = traffic_gen.request(self.pool, item, self.seed, index)
                t = time.time_ns()
                if t >= t_end:
                    return
                rec = {"index": index, "views": item["views"], "submit": t, "done": None,
                       "ok": False, "depth_gt": "depth_gt_index" in req}
                try:
                    out = self.batcher.submit(timeout=mix["timeout_s"], **req)
                    rec["ok"] = True
                except Exception as e:  # noqa: BLE001 - a failed request is counted
                    rec["error"] = repr(e)
                rec["done"] = time.time_ns()
                with lock:
                    records.append(rec)
                    if rec["ok"] and index in self.keep:
                        kept[index] = (req, out)
                    if rec["ok"] and item["views"] > largest[0]:
                        # the largest answered so far is always checked
                        largest[:] = [item["views"], index, req, out]

        threads = [threading.Thread(target=client) for _ in range(mix["clients"])]
        ctl.start()
        for th in threads:
            th.start()
        ctl.run_until(t_end)
        for th in threads:
            th.join()
        ctl.stop()
        self.kept = kept
        if largest[1] is not None:
            self.kept[largest[1]] = tuple(largest[2:])
            self.largest = largest[1]
        arch, size = self.arch, mix["image_size"]
        for r in records:
            r["flops"] = flops.forward_flops(arch, r["views"], size, size, r["depth_gt"])
            r["attn_bound_s"] = flops.attention_bound_s(arch, r["views"], size, size)
        return {"t0": t0, "t_end": t_end, "requests": sorted(records, key=lambda r: r["submit"])}

    def free(self):
        self.batcher.close()
        del self.batcher, self.session, self.model

    def check(self, window: dict) -> dict:
        """The reference over the largest answered request and a seeded
        sample of the others; every answer compared frame by frame."""
        picks = [self.largest] if self.kept else []
        picks += [i for i in sorted(self.kept) if i in self.keep and i not in picks]
        picks = picks[: 1 + self.mix["check"]["sample"]]
        ref = self.reference()
        readings = compare.Worst()
        for i in picks:
            req, out = self.kept[i]
            want = self.run_reference(ref, req)
            readings.add(compare.dense(out, want))
        del ref
        failed = sum(1 for r in window["requests"] if not r["ok"])
        return {"readings": readings.values, "checked": len(picks),
                "views_checked": int(sum(self.item(i)["views"] for i in picks)),
                "failed": failed, "attempted": len(window["requests"])}

    def run_reference(self, ref, req) -> dict:
        import torch

        dev = self.device
        S = req["images"].shape[0]

        def t(x):
            return torch.as_tensor(np.asarray(x), device=dev)[None]

        cam = dep = ex = K = depth = valid = None
        if "camera_gt_index" in req:
            cam = torch.zeros(1, S, dtype=torch.bool, device=dev)
            cam[0, req["camera_gt_index"]] = True
            ex, K = t(req["extrinsics"]), t(req["intrinsics"])
        if "depth_gt_index" in req:
            dep = torch.zeros(1, S, dtype=torch.bool, device=dev)
            dep[0, req["depth_gt_index"]] = True
            depth, valid = t(req["depth"]), t(req["mask"])
        with torch.no_grad():
            out = ref(t(req["images"]), ex, K, depth, valid, cam, dep)
        return {k: v[0].cpu().numpy() if k != "pose_enc_list" else v[:, 0].cpu().numpy()
                for k, v in out.items()}
