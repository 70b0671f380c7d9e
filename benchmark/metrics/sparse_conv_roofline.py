"""sparse_conv_roofline.<mode>: the least time of every sparse conv of the
traced window, as a share of the device time of the sparse-conv layer's
kernels there. A conv's least time is the larger of its bytes at 3.35
TB/s and its FLOPs at 495 TFLOP/s; it counts each input row it reads
once, each output row once and its weights once, and 2 * hits * Cin *
Cout FLOPs, for the forward and, in training, for each gradient the
backward computes (dX, dW), with hits and rows from the reference's
rulebooks on the same batches. The layer's kernels are those whose name
matches a pattern of a file in ``sparse_conv_roofline/kernels/``."""

import re
from pathlib import Path

KERNELS = Path(__file__).resolve().parent / "sparse_conv_roofline" / "kernels"


def patterns():
    return [re.compile(p.read_text().strip())
            for p in sorted(KERNELS.glob("*.txt"))]


def least_seconds(rec, peak_flops, peak_bytes):
    """The conv's least time over the passes it makes."""
    w = rec["K"] * rec["cin"] * rec["cout"] * 4
    flops = 2.0 * rec["hits"] * rec["cin"] * rec["cout"]
    rows = rec["rows_in"] * rec["cin"] * 4 + rec["rows_out"] * rec["cout"] * 4
    passes = 1 + int(rec["dx"]) + int(rec["dw"])
    return passes * max((rows + w) / peak_bytes, flops / peak_flops)


def read(ctx, name):
    tr, convs = ctx.get("trace"), ctx.get("pool_convs")
    if tr is None or convs is None or not name.endswith(ctx["mode"]):
        return None
    pats = patterns()
    device = sum(e - s for s, e, n, *_ in tr.kernels
                 if any(p.search(n) for p in pats)) / 1e6
    if device <= 0:
        return None
    least = sum(least_seconds(r, ctx["peak_flops"], ctx["peak_bytes_per_s"])
                for b in ctx["trace_ids"] for r in convs[b])
    return 100.0 * least / device
