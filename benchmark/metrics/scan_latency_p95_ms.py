"""scan_latency_p95_ms: the 95th percentile (numpy's linear
interpolation) of every scan of the window, each timed on the host clock
from the hand-over of its host batch to its labels on the host."""

import numpy as np


def read(ctx, name):
    lat = ctx.get("latencies_s")
    if ctx["mode"] != "infer" or not lat:
        return None
    return float(np.percentile(np.asarray(lat) * 1e3, 95))
