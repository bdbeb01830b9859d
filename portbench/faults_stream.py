"""Faults planted in the frame-causal stream's timed path, for the tests
and the control runs of the cell stream-s256 (`portbench.controls_stream`):
each must turn `correct` false. Never used by a benchmark run.

  - own_keys: a frame's attention leaves out its own keys and values (they
    are still written to the cache); frame 0, which has no other, keeps
    them;
  - oldest_dropped: from frame 1 on, the attention leaves out the cache's
    oldest frame (frame 0);
  - slot0_everywhere: every frame takes slot 0 of the camera and register
    tokens, the clip's first frame's.

Both cache faults act on every layer cache, the global blocks' and the
camera head's trunk's.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(owner, name, make):
    original = getattr(owner, name)
    setattr(owner, name, make(original))
    try:
        yield None
    finally:
        setattr(owner, name, original)


def _own_keys(append):
    def broken(self, k, v):
        keys, values = append(self, k, v)
        return (keys[:, :self.start], values[:, :self.start]) if self.start else (keys, values)

    return broken


def _oldest_dropped(append):
    def broken(self, k, v):
        keys, values = append(self, k, v)
        frame = self.stop - self.start
        return (keys[:, frame:], values[:, frame:]) if self.start else (keys, values)

    return broken


def _slot0_everywhere(expand):
    def broken(tok, B, S, dtype, has_first=True):
        return expand(tok, B, S, dtype, True)

    return broken


@contextlib.contextmanager
def planted(name: str):
    """The fault `name`, planted in the program while the block runs."""
    from omnivggt_tpu_torch.models import aggregator
    from omnivggt_tpu_torch.models.stream import LayerCache

    if name == "own_keys":
        cm = _patched(LayerCache, "append", _own_keys)
    elif name == "oldest_dropped":
        cm = _patched(LayerCache, "append", _oldest_dropped)
    elif name == "slot0_everywhere":
        cm = _patched(aggregator, "_expand_special_token", _slot0_everywhere)
    else:
        raise KeyError(f"no stream fault {name!r}")
    with cm:
        yield None
