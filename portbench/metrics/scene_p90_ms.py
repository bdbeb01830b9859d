"""90th percentile of the latency, submit to answer, of every request sent
in the window; a request that failed counts as infinitely late."""

import math

import numpy as np


def read(rec):
    lat = [(r["done"] - r["submit"]) / 1e6 if r["ok"] else math.inf for r in rec["requests"]]
    if not lat:
        return None
    return float(np.percentile(lat, 90))
