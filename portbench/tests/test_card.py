"""On the card, at each cell's own size: the lower-precision control and
the planted faults are not correct, and a sound run is. Marked `cuda`:
skips without a card (decided inside the test); run on the card with

    python3 -m pytest portbench/tests/test_card.py -m cuda -q
"""

import pytest

CASES = [
    ("serve-mixed", "program", True), ("serve-mixed", "control", False),
    ("serve-mixed", "altered", False),
    ("scene-s32", "program", True), ("scene-s32", "control", False),
    ("scene-s32", "altered", False),
    ("train-b2s4", "program", True), ("train-b2s4", "control", False),
    ("train-b2s4", "unchanged", False), ("train-b2s4", "half_batch", False),
    ("train-b2s4", "bwd_dk", False), ("train-b2s4", "bwd_dq", False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("workload,variant,correct", CASES)
def test_full_size_check(workload, variant, correct):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cell runs at its full size on the card")
    from portbench import controls

    out = controls.run_variant(workload, variant, 3_000_000_017, 10.0, torch.device("cuda"))
    assert out["correct"] is correct, out
