"""Rehearse a cell on the CPU at the program's tiny test configuration.

    python -m portbench.rehearse --workload <name> [--seconds 3] [--trace 0|1]

Runs the whole of a cell's run (set-up, window, the reference's check)
with the configuration cut to `tiny_test_config` and the traffic to 28 px
scenes, on the CPU. It shows that the harness drives the program and that
the check compares; it measures nothing: it prints the compared numbers and
what the run counted, and no metric. The benchmark's own command
(`portbench.run`) refuses to run without a card.
"""

from __future__ import annotations

import argparse
import json
import sys

from portbench import harness

harness.prepare_environment()

TINY_TRAFFIC = {
    "serve": {"image_size": 28, "views": {"min": 2, "max": 5}, "cycle": 8,
              "pool_frames": 6, "check": {"sample": 2}},
    "library": {"image_size": 28, "views": 6, "camera_frames": 2, "pool_frames": 6,
                "check": {"among_first": 2}, "warmup": 1},
    "train": {"image_size": 28, "pool_frames": 6, "scenes": 6, "samples_per_shard": 2},
}


def tiny_cell(workload: str) -> dict:
    """The cell with the tiny configuration and a 28 px traffic mix."""
    import dataclasses

    from omnivggt_tpu_torch.config import tiny_test_config
    from portbench import config as C

    cell = C.cell(workload)
    program = cell["config_data"]["program"]
    extra = {k: v for k, v in program.items() if k == "approx_gelu"}
    cfg = dataclasses.replace(tiny_test_config(), **extra)
    cell["program_cfg"] = cfg
    cell["config_data"] = dict(cell["config_data"], architecture=C.arch_of(cfg))
    mix = dict(cell["traffic_data"])
    mix.update(TINY_TRAFFIC[mix["driver"]])
    cell["traffic_data"] = mix
    return cell


def rehearse(workload: str, seed: int = 1, seconds: float = 3.0, trace: bool = False,
             fault=None, program_overrides=None) -> tuple:
    import torch

    from portbench import run

    torch.set_num_threads(2)
    result, compared = run.execute(workload, seed, seconds, trace, device=torch.device("cpu"),
                                   cell=tiny_cell(workload), fault=fault,
                                   program_overrides=program_overrides, setup_from_call=True)
    result["metrics"] = {}  # a CPU run measures nothing
    return result, compared


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    result, compared = rehearse(args.workload, args.seed, args.seconds, bool(args.trace))
    for c in compared:
        print(f"compared {c['name']}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps({"rehearsal": True, "correct": result["correct"],
                      "attempted": result["attempted"], "failed": result["failed"],
                      "checked": result["checked"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
