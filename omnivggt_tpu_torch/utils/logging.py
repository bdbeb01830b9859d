"""Training metric logging (counterpart of omnivggt_tpu/utils/logging.py):
windowed smoothing, global averages, an iteration wrapper with ETA, and
optional JSONL persistence (one record per update, with a wall-clock time).
Tensor values (device scalars) are read with .item()."""

from __future__ import annotations

import json
import time
from collections import defaultdict, deque
from typing import Iterable, Optional

import numpy as np


class SmoothedValue:
    """Track a series with a smoothing window and global statistics."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        value = float(value)
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self):
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self):
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def max(self):
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(
            median=self.median, avg=self.avg, global_avg=self.global_avg,
            max=self.max, value=self.value,
        )


class MetricLogger:
    def __init__(self, delimiter: str = "  ", jsonl_path: Optional[str] = None):
        self.meters = defaultdict(SmoothedValue)
        self.delimiter = delimiter
        self.jsonl_path = jsonl_path

    def update(self, **kwargs):
        record = {}
        for k, v in kwargs.items():
            if hasattr(v, "item"):
                v = float(v.item())
            self.meters[k].update(v)
            record[k] = v
        if self.jsonl_path:
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps({"t": time.time(), **record}) + "\n")

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self):
        return self.delimiter.join(
            f"{name}: {meter}" for name, meter in self.meters.items()
        )

    def log_every(self, iterable: Iterable, print_freq: int, header: str = ""):
        """Yield from iterable, printing smoothed meters + ETA every
        print_freq steps. Streams lazily: an unsized (or infinite) iterable
        is consumed one item at a time — ETA is simply omitted."""
        i = 0
        n = len(iterable) if hasattr(iterable, "__len__") else None
        start = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        t0 = time.time()
        for obj in iterable:
            yield obj
            iter_time.update(time.time() - t0)
            if i % print_freq == 0 or (n is not None and i == n - 1):
                if n is not None:
                    eta = iter_time.global_avg * (n - i)
                    progress = f"[{i}/{n}] eta: {eta:.0f}s"
                else:
                    progress = f"[{i}]"
                print(f"{header} {progress} {self} time: {iter_time}")
            t0 = time.time()
            i += 1
        total = time.time() - start
        print(
            f"{header} Total time: {total:.1f}s "
            f"({total / max(i, 1):.4f} s/it)"
        )
