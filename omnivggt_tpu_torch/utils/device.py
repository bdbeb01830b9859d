"""The device the port's entry points run on: CUDA unless the caller asks
for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device`, or "cuda" when None. Raises when CUDA is asked for and
    there is none: the CPU runs only when named (device="cpu" in the
    library, --device cpu on the command line)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU by default; pass "
            "device='cpu' (--device cpu on the command line) to run on the CPU"
        )
    return dev
