"""Training dataset: scene folders -> model-ready batches (counterpart of
omnivggt_tpu/data/dataset.py).

  - `SceneDataset`: a directory of scenes: example-layout folders (images/
    [cameras/] [depths/]), extracted ScanNet scenes and CO3D sequences,
    each read through the format-dispatching `data/formats.load_scene`.
    Each scene is loaded once (LRU-cached), and its ground-truth world
    points come from unprojecting GT depth with GT cameras.
  - View selection: a sample draws S views around a random anchor by the
    pairwise camera-distance ranking (data/view_selection.py).
  - Modality-dropout masks: each sample keeps camera/depth GT for a random
    subset of frames, with a camera-kept view first.
  - Optional photometric augmentation (data/augmentation.py), drawn from a
    torch.Generator seeded from the sample's numpy rng.
  - `prefetch()`: a bounded background-thread iterator so host-side loading
    overlaps device steps.

Samples are numpy; with the same seed they equal the JAX package's
(without augmentation: the two packages draw its parameters from different
generators).
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterator, List, Optional

import numpy as np
import torch

from omnivggt_tpu_torch.data.formats import is_co3d_sequence, is_scannet_scene, load_scene
from omnivggt_tpu_torch.data.view_selection import compute_ranking
from omnivggt_tpu_torch.utils.geometry import unproject_depth_map_to_point_map
from omnivggt_tpu_torch.utils.profiling import span


def _normalizing_transform(exv_w2c: np.ndarray, valid: np.ndarray):
    """The sample-frame normalisation (numpy twin of the aggregator's
    masked_normalize_extrinsics): rebase the world to the first camera-valid
    view and rescale by the mean relative translation of the other valid
    views. Returns (T (4,4) world->view0, scale)."""
    S = len(exv_w2c)
    i0 = int(np.argmax(valid))
    E = np.tile(np.eye(4, dtype=np.float64), (S, 1, 1))
    E[:, :3] = exv_w2c
    T = E[i0]
    En = E @ np.linalg.inv(T)[None]
    t = En[:, :3, 3]
    excl = valid & (np.arange(S) != i0)
    if excl.any():
        scale = max(float(np.linalg.norm(t - t[i0], axis=-1)[excl].mean()), 1e-6)
    else:
        scale = 1.0
    return T.astype(np.float32), scale


class SceneDataset:
    def __init__(
        self,
        root: str,
        views_per_sample: int = 4,
        target_size: int = 518,
        camera_keep_prob: float = 0.5,
        depth_keep_prob: float = 0.5,
        augment=None,
        seed: int = 0,
        cache_scenes: int = 16,
    ):
        """augment: None, or augment(generator, view) -> view on (H, W, 3)
        tensors (data/augmentation.make_augmentation), applied to each view
        of a sample after the normalisation."""
        self.views_per_sample = views_per_sample
        self.camera_keep_prob = camera_keep_prob
        self.depth_keep_prob = depth_keep_prob
        self.augment = augment
        self.target_size = target_size
        self._rng = np.random.default_rng(seed)

        def is_scene(p: str) -> bool:
            return (
                os.path.isdir(os.path.join(p, "images"))
                or is_scannet_scene(p)
                or is_co3d_sequence(p)
            )

        self.scene_dirs: List[str] = sorted(
            p
            for d in os.listdir(root)
            if os.path.isdir(p := os.path.join(root, d)) and is_scene(p)
        )
        if is_scene(root):
            self.scene_dirs.insert(0, root)  # root itself is a scene
        if not self.scene_dirs:
            raise ValueError(f"no scene folders under {root}")
        # preprocessed scenes are hundreds of MB each at 518 px; bound the
        # cache (LRU) so large training roots don't accumulate every scene
        # in host RAM (past that scale, stream shards: data/streaming.py)
        self.cache_scenes = max(1, cache_scenes)
        self._cache = {}

    def _load(self, scene_dir: str):
        return load_scene(scene_dir, target_size=self.target_size)

    def _scene(self, idx: int):
        if idx in self._cache:
            self._cache[idx] = self._cache.pop(idx)  # refresh LRU order
        else:
            while len(self._cache) >= self.cache_scenes:
                self._cache.pop(next(iter(self._cache)))
            images, ex, K, depths, masks, d_idx, c_idx = self._load(
                self.scene_dirs[idx]
            )
            ranking = None
            if len(c_idx) == images.shape[0] and images.shape[0] > 1:
                # rank on camera-to-world poses: the distance metric's
                # translation term must compare camera CENTRES, and the w2c
                # translation is -R*c, not the centre
                E = np.tile(np.eye(4, dtype=np.float32), (images.shape[0], 1, 1))
                E[:, :3] = ex[0]
                ranking, _ = compute_ranking(np.linalg.inv(E))
            self._cache[idx] = (images, ex, K, depths, masks, d_idx, c_idx, ranking)
        return self._cache[idx]

    def __len__(self):
        return len(self.scene_dirs)

    def sample(self, rng: Optional[np.random.Generator] = None) -> dict:
        """One training sample: S views of one scene with GT + dropout masks.

        Supervision targets are expressed in the sample's normalised frame
        (rebased to the first camera-valid view, translations rescaled by the
        mean camera distance — the same normalisation camera_loss and the
        aggregator's injection apply), so world points / depths / cameras are
        mutually consistent across scenes with arbitrary annotation origins.
        """
        rng = rng or self._rng
        images, ex, K, depths, masks, d_idx, c_idx, ranking = self._scene(
            int(rng.integers(len(self.scene_dirs)))
        )
        n = images.shape[0]
        S = min(self.views_per_sample, n)

        anchor = int(rng.integers(n))
        if ranking is not None:
            # anchor + its nearest views (skip self at rank 0), lightly shuffled
            pool = ranking[anchor][: max(2 * S, S + 1)]
            pool = [v for v in pool if v != anchor]
            rng.shuffle(pool)
            views = np.asarray([anchor] + pool[: S - 1])
        else:
            views = rng.permutation(n)[:S]

        have_cam = np.isin(views, c_idx)
        cam_mask = have_cam & (rng.uniform(size=S) < self.camera_keep_prob)
        # the reference requires GT on the first frame whenever any frame has
        # it (README.md:176): put a camera-kept view first
        if cam_mask.any() and not cam_mask[0]:
            j = int(np.argmax(cam_mask))
            views[[0, j]] = views[[j, 0]]
            order = np.arange(S)
            order[[0, j]] = order[[j, 0]]
            have_cam, cam_mask = have_cam[order], cam_mask[order]
        have_depth = np.isin(views, d_idx)
        depth_mask = have_depth & (rng.uniform(size=S) < self.depth_keep_prob)

        imgs = images[views]  # (S, H, W, 3)
        exv, Kv = ex[0][views].copy(), K[0][views].copy()
        depthv, maskv = depths[0][views].copy(), masks[0][views].copy()

        # depth supervision validity needs only depth GT; world points also
        # need the camera that unprojects them
        depth_valid = (maskv * (depthv[..., 0] > 1e-5) * have_depth[:, None, None]).astype(np.float32)
        world_points = np.zeros(imgs.shape[:3] + (3,), np.float32)
        point_valid = np.zeros(imgs.shape[:3], np.float32)
        usable = have_cam & have_depth
        if usable.any():
            world_points[usable] = unproject_depth_map_to_point_map(
                depthv[usable], exv[usable], Kv[usable]
            )
            point_valid[usable] = depth_valid[usable]

        # rebase supervision to the first camera-valid view's normalised frame
        if have_cam.any():
            T, scale = _normalizing_transform(exv, have_cam)
            world_points = (world_points @ T[:3, :3].T + T[:3, 3]) / scale
            depthv = depthv / scale
            E = np.tile(np.eye(4, dtype=np.float32), (S, 1, 1))
            E[:, :3] = exv
            En = E @ np.linalg.inv(T)[None]
            En[:, :3, 3] /= scale
            exv = En[:, :3].astype(np.float32)
            # frames without camera GT carry no meaningful extrinsics
            exv[~have_cam] = 0.0

        if self.augment is not None:
            # one generator a sample, seeded from the sample's rng (which so
            # advances as the JAX package's does), drawn from view by view
            gen = torch.Generator().manual_seed(int(rng.integers(2**31)))
            imgs = np.stack([self.augment(gen, torch.from_numpy(im)).numpy() for im in imgs])

        return {
            "images": imgs[None],
            "extrinsics": exv[None],
            "intrinsics": Kv[None],
            "depth": depthv[None],
            "depth_valid": depth_valid[None],
            "world_points": world_points[None],
            "point_valid": point_valid[None],
            "camera_mask": cam_mask,
            "depth_mask": depth_mask,
            "camera_valid": have_cam,
        }

    def batches(self, n_steps: Optional[int] = None) -> Iterator[dict]:
        step = 0
        while n_steps is None or step < n_steps:
            yield self.sample()
            step += 1


def prefetch(iterator: Iterator[dict], depth: int = 2) -> Iterator[dict]:
    """Run `iterator` in a background thread with a bounded queue so host-side
    loading overlaps device execution. Worker exceptions propagate to the
    consumer (a corrupt sample must fail the run, not silently end it)."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _END = object()

    def worker():
        try:
            for item in iterator:
                q.put(item)
            q.put(_END)
        except BaseException as e:  # noqa: BLE001 — re-raised in the consumer
            q.put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        with span("data.wait"):
            item = q.get()
        if item is _END:
            return
        if isinstance(item, BaseException):
            raise item
        yield item
