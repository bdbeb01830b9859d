"""90th percentile of the latency, submit to outputs on the card, of every
frame in the window. The window holds whole clips only, so frames early and
late in a clip, whose cache is short and long, weigh as a live stream weighs
them. A traced run's profiler runs over some 50 frames in the middle of the
first clip, whose latencies sit below the percentile; its stop is taken
between two frames, inside neither's latency."""

import numpy as np

from portbench.readings import answered


def read(rec):
    lat = [(r["done"] - r["submit"]) / 1e6 for r in answered(rec)]
    return float(np.percentile(lat, 90)) if lat else None
