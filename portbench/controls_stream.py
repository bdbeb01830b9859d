"""The readings that stream-s256's limits are set from: `portbench.controls`
with the stream's own planted faults (`faults_stream.py`).

    python3 -m portbench.controls_stream --plan program=1,2,3 \
        --plan control=4,5 --plan own_keys=6 --plan oldest_dropped=7 \
        --plan slot0_everywhere=8 [--seconds 20] [--clip-frames 96]

Prints one JSON line a seed, as `portbench.controls` does. The benchmark's
own runs never run this. --clip-frames runs the cell with shorter clips:
the check reads frames 0..t of the first clip only, t at most the top of
the traffic's check range, so clips one frame longer than that top read
the same numbers as the cell's own, in a fraction of the time.
"""

from __future__ import annotations

import argparse
import json
import sys

from portbench import controls, harness

WORKLOAD = "stream-s256"


def run_variant(variant: str, seed: int, seconds: float, device=None, cell=None) -> dict:
    from portbench import faults_stream, run

    if variant in ("program", "control"):
        return controls.run_variant(WORKLOAD, variant, seed, seconds, device, cell)
    with faults_stream.planted(variant):
        result, _, readings = run.execute(WORKLOAD, seed, seconds, False, device=device,
                                          setup_from_call=True, cell=cell, with_readings=True)
    return {"variant": variant, "seed": seed, "correct": result["correct"],
            "readings": readings, "checked": result["checked"],
            "attempted": result["attempted"], "failed": result["failed"],
            "metrics": {k: v["value"] for k, v in result["metrics"].items()}}


def short_cell(clip_frames: int) -> dict:
    """The cell with clips of `clip_frames`, which must hold the check's
    frames."""
    from portbench import config as C

    cell = C.cell(WORKLOAD)
    top = cell["traffic_data"]["check"]["frame_range"][1]
    if clip_frames <= top:
        raise SystemExit(f"clips of {clip_frames} frames do not hold the check's frame {top}")
    cell["traffic_data"] = dict(cell["traffic_data"], clip_frames=clip_frames,
                                trace_from_frame=min(cell["traffic_data"]["trace_from_frame"],
                                                     clip_frames - 1))
    return cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--plan", action="append", required=True,
                    help="<variant>=<seed>,<seed>,...: program, control or a stream fault")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--clip-frames", type=int, default=None,
                    help="clips of this many frames (default the traffic's)")
    args = ap.parse_args(argv)
    import torch  # noqa: F401 - after the environment is set (portbench.controls)

    device = harness.require_devices(1)
    cell = short_cell(args.clip_frames) if args.clip_frames else None
    print(f"portbench: card {harness.card_line()}", file=sys.stderr)
    for plan in args.plan:
        variant, seeds = plan.split("=")
        for seed in (int(s) for s in seeds.split(",")):
            print(json.dumps(run_variant(variant, seed, args.seconds, device, cell)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
