"""The readings that a cell's limits are set from: the program on many
seeds, its lower-precision control and the planted faults, at the cell's
own size, several seeds in one process (set-up is paid once for the
kernels and the imports).

    python3 -m portbench.controls --workload <name> --plan program=1,2,3 \
        --plan control=4,5,6 --plan <fault>=7 [--seconds 20]

Prints one JSON line a seed: the variant, the seed, every reading (also
those not compared), `correct` under the committed limits and what was
checked. The control is the program with the configuration fields of the
cell's limits file ("control"); faults are portbench/faults.py's. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

from portbench import harness

harness.prepare_environment()


def run_variant(workload: str, variant: str, seed: int, seconds: float, device=None,
                cell=None) -> dict:
    from portbench import faults, run

    limits_file = run.limits_file(workload)
    overrides = limits_file["control"]["program"] if variant == "control" else None
    if variant in ("program", "control"):
        result, compared, readings = run.execute(
            workload, seed, seconds, False, device=device, program_overrides=overrides,
            setup_from_call=True, cell=cell, with_readings=True)
    else:
        with faults.planted(variant) as wrap:
            result, compared, readings = run.execute(
                workload, seed, seconds, False, device=device, fault=wrap,
                setup_from_call=True, cell=cell, with_readings=True)
    return {"variant": variant, "seed": seed, "correct": result["correct"],
            "readings": readings, "checked": result["checked"],
            "attempted": result["attempted"], "failed": result["failed"],
            "metrics": {k: v["value"] for k, v in result["metrics"].items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--plan", action="append", required=True,
                    help="<variant>=<seed>,<seed>,...: program, control or a fault's name")
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args(argv)
    import torch  # noqa: F401 - after the environment is set

    from portbench import config as C

    device = harness.require_devices(C.cell(args.workload)["chips"])
    print(f"portbench: card {harness.card_line()}", file=sys.stderr)
    for plan in args.plan:
        variant, seeds = plan.split("=")
        for seed in (int(s) for s in seeds.split(",")):
            line = run_variant(args.workload, variant, seed, args.seconds, device)
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
