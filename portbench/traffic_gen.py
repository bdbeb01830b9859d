"""The one generator of scenes: every traffic mix's requests are drawn here
from its parameters and the seed.

A mix fixes the multiset of work: scene sizes in exact shares of a cycle
(largest remainders of the weights), modality layouts in exact shares, and
how many frames of a scene carry GT. The seed changes only the order, the
pixels, the cameras and the depth, so every seed asks for the same work.
The order is balanced: each class's requests are spread evenly over the
cycle from a seeded offset, so any run of consecutive requests holds each
class within one of its share, and a window that ends inside a cycle still
served the mix.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def exact_counts(weights: Dict[int, float], total: int) -> Dict[int, int]:
    """Integer counts proportional to `weights`, summing to `total`
    (largest remainders, ties to the smaller key)."""
    w = np.array(list(weights.values()), np.float64)
    raw = w / w.sum() * total
    counts = np.floor(raw).astype(int)
    order = sorted(range(len(raw)), key=lambda i: (-(raw[i] - counts[i]), i))
    for i in order[: total - counts.sum()]:
        counts[i] += 1
    return dict(zip(weights, counts.tolist()))


def view_weights(spec: dict) -> Dict[int, float]:
    """Weights of the scene sizes min..max: P(S) ~ 1/S."""
    return {s: 1.0 / s for s in range(spec["min"], spec["max"] + 1)}


def balanced(counts: Dict[int, int], rng) -> list:
    """The classes of `counts` in an order where class c's k-th member sits
    at (k + u_c) / count_c of the way, u_c drawn from `rng`."""
    keyed = []
    for value, count in counts.items():
        u = rng.random()
        keyed += [((k + u) / count, value) for k in range(count)]
    keyed.sort()
    return [v for _, v in keyed]


def plan(mix: dict, seed: int, cycle_index: int) -> List[dict]:
    """One cycle of requests: [{"views", "camera", "depth"}] where camera and
    depth are the GT shares of the layout, in a balanced order drawn from
    (seed, cycle)."""
    rng = np.random.default_rng([seed, cycle_index])
    n = mix["cycle"]
    sizes = balanced(exact_counts(view_weights(mix["views"]), n), rng)
    shares = {i: m["share"] for i, m in enumerate(mix["modalities"])}
    layouts = balanced(exact_counts(shares, n), rng)
    return [{"views": int(sizes[i]), "camera": mix["modalities"][layouts[i]]["camera"],
             "depth": mix["modalities"][layouts[i]]["depth"]} for i in range(n)]


def _subset(rng, S: int, share: float) -> List[int]:
    if share <= 0:
        return []
    k = max(1, int(round(share * S)))
    return sorted(rng.choice(S, size=min(k, S), replace=False).tolist())


def random_cameras(rng, S: int, size: int):
    """(S, 3, 4) world-to-camera extrinsics and (S, 3, 3) intrinsics."""
    q = rng.normal(size=(S, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    x, y, z, w = q.T
    R = np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
        2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
        2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1).reshape(S, 3, 3)
    ex = np.concatenate([R, rng.normal(size=(S, 3, 1))], axis=-1).astype(np.float32)
    K = np.zeros((S, 3, 3), np.float32)
    K[:, 0, 0] = K[:, 1, 1] = size * rng.uniform(0.8, 1.6, size=S)
    K[:, 0, 2] = K[:, 1, 2] = size / 2
    K[:, 2, 2] = 1
    return ex, K


class FramePool:
    """Images and depth maps drawn once per run; a scene takes a seeded
    choice of them, so scenes differ without drawing every pixel anew."""

    def __init__(self, seed: int, size: int, frames: int):
        rng = np.random.default_rng([seed, 1 << 20])
        coarse = rng.random((frames, size // 14, size // 14, 3), np.float32)
        fine = rng.random((frames, size, size, 3), np.float32)
        # half pixel noise, half a 14-pixel structure
        self.images = 0.5 * fine + 0.5 * np.repeat(np.repeat(coarse, 14, 1), 14, 2)
        self.depth = (0.5 + 2.5 * rng.random((frames, size, size, 1), np.float32))
        self.size = size

    def scene(self, rng, S: int) -> tuple:
        idx = rng.choice(len(self.images), size=S, replace=S > len(self.images))
        return self.images[idx], self.depth[idx]


def request(pool: FramePool, item: dict, seed: int, index: int) -> dict:
    """The arguments of one served request (InferenceSession.infer's)."""
    rng = np.random.default_rng([seed, 2 << 20, index])
    S = item["views"]
    images, depth = pool.scene(rng, S)
    req = {"images": images}
    cam = _subset(rng, S, item["camera"])
    if cam:
        ex, K = random_cameras(rng, S, pool.size)
        req.update(extrinsics=ex, intrinsics=K, camera_gt_index=cam)
    dep = _subset(rng, S, item["depth"])
    if dep:
        req.update(depth=depth, mask=np.ones(depth.shape[:3], np.float32), depth_gt_index=dep)
    return req
