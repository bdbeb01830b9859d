"""The comparison that decides `correct`: the program's outputs against the
plain reference's, as numbers that each have a limit (limits/<cell>.json).

Served and library scenes, frame by frame (`dense`): pose_rel is the
largest absolute error of the 9-value pose encoding over that frame's
largest reference value; each dense output (depth, its confidence, world
points, their confidence) reads the median absolute error over the frame's
pixels divided by the median magnitude of the reference's. The number kept
is the worst frame's. A missing output, a wrong shape or a value that is
not finite reads infinity.

Training (`by_leaf`): for every parameter the gap between the program's
norm and the reference's, against the larger of the reference's norm of
that leaf and the median leaf's; the number kept is the worst leaf's
(by_leaf) or the median leaf's (median_leaf), over a named set of leaves.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np

DENSE = {"depth": "depth", "depth_conf": "depth_conf", "points": "world_points",
         "points_conf": "world_points_conf"}


class Worst:
    """The largest reading of each number over everything added."""

    def __init__(self):
        self.values: Dict[str, float] = {}

    def add(self, readings: Dict[str, float]) -> None:
        for k, v in readings.items():
            v = float(v) if math.isfinite(v) else math.inf
            self.values[k] = max(self.values.get(k, -math.inf), v)


def _frames(x: np.ndarray) -> np.ndarray:
    return x.reshape(x.shape[0], -1).astype(np.float64)


def dense(got: dict, want: dict) -> Dict[str, float]:
    """Readings of one scene: `got` and `want` hold (S, ...) arrays."""
    out = {}
    g, w = got.get("pose_enc"), want["pose_enc"]
    if g is None or np.shape(g) != w.shape or not np.all(np.isfinite(g)):
        out["pose_rel"] = math.inf
    else:
        err = np.abs(np.asarray(g, np.float64) - w)
        out["pose_rel"] = float((err.max(axis=-1) / np.maximum(np.abs(w).max(axis=-1), 1e-30)).max())
    for name, key in DENSE.items():
        g, w = got.get(key), want[key]
        if g is None or np.shape(g) != w.shape or not np.all(np.isfinite(g)):
            out[name] = math.inf
            continue
        gf, wf = _frames(np.asarray(g)), _frames(w)
        err = np.median(np.abs(gf - wf), axis=1) / np.maximum(np.median(np.abs(wf), axis=1),
                                                                1e-30)
        out[name] = float(err.max())
    return out


def by_leaf(got: Dict[str, float], want: Dict[str, float], keep=None) -> float:
    """Worst leaf of |got - want| / max(want, median of want), over the
    leaves `keep` names (all of want's by default)."""
    return worst_leaves(got, want, keep)[0][0]


def median_leaf(got: Dict[str, float], want: Dict[str, float], keep=None) -> float:
    """The median leaf's gap, by_leaf's measure."""
    names = list(want) if keep is None else [n for n in want if n in keep]
    if any(n not in got or not math.isfinite(got[n]) for n in names):
        return math.inf
    med = float(np.median([want[n] for n in names]))
    return float(np.median([abs(got[n] - want[n]) / max(want[n], med) for n in names]))


def worst_leaves(got: Dict[str, float], want: Dict[str, float], keep=None, count: int = 1):
    """[(gap, leaf)] of the `count` worst leaves, by_leaf's measure."""
    names = list(want) if keep is None else [n for n in want if n in keep]
    if any(n not in got or not math.isfinite(got[n]) for n in names):
        return [(math.inf, "not finite")]
    med = float(np.median([want[n] for n in names]))
    gaps = sorted(((abs(got[n] - want[n]) / max(want[n], med), n) for n in names), reverse=True)
    return gaps[:count]
