"""The check that decides `correct`, driven end to end on the CPU at the
tiny test configuration (portbench.rehearse's cells): a sound run passes,
every planted fault that a cell can have fails it, and each cell's
lower-precision control reads far above the program."""

import math

import pytest
import torch

from portbench import controls
from portbench.rehearse import tiny_cell

torch.set_num_threads(2)


def _run(workload, variant, seed=5):
    return controls.run_variant(workload, variant, seed, 1.5, device=torch.device("cpu"),
                                cell=tiny_cell(workload))


@pytest.mark.parametrize("workload", ["serve-mixed", "scene-s32", "train-b2s4"])
def test_a_sound_run_is_correct(workload):
    out = _run(workload, "program")
    assert out["correct"], out
    assert out["checked"]["answers"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("workload,fault", [
    ("serve-mixed", "altered"), ("scene-s32", "altered"),
    ("train-b2s4", "unchanged"), ("train-b2s4", "half_batch"),
    ("train-b2s4", "bwd_dk"), ("train-b2s4", "bwd_dq"),
])
def test_a_planted_fault_is_not_correct(workload, fault):
    out = _run(workload, fault)
    assert not out["correct"], out


@pytest.mark.parametrize("workload", ["serve-mixed", "scene-s32", "train-b2s4"])
def test_the_control_reads_far_above_the_program(workload):
    """At the tiny size the program computes in float32 like the reference,
    so its readings are rounding; the control's lower precision reads at
    least ten times more on the largest of them."""
    sound = _run(workload, "program")["readings"]
    control = _run(workload, "control")["readings"]
    worst = max(sound, key=lambda k: sound[k])
    assert max(control.values()) >= 10 * max(sound[worst], 1e-7), (sound, control)
    assert all(math.isfinite(v) for v in control.values())
