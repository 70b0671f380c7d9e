"""idle_pct.<mode>: the share of an iteration's time in which nothing
runs on the device: one less the device's busy seconds an iteration (the
union of the kernel, copy and set intervals in the traced window's raw
device events, over its iterations) over the measured window's seconds
an iteration. The traced window's own length is not the denominator:
the profiler slows the host by about half in these cells, which would
read as idle time."""


def read(ctx, name):
    tr = ctx.get("trace")
    if tr is None or not tr.device or not name.endswith(ctx["mode"]):
        return None
    busy = tr.busy_s() / len(ctx["trace_ids"])
    step = ctx["window_s"] / len(ctx["window_ids"])
    return 100.0 * (1.0 - busy / step)
