"""launches_per_scan.<mode>: the kernels the traced window launched, per
scan it labelled (a TTA frame counts once)."""


def read(ctx, name):
    tr = ctx.get("trace")
    if tr is None or not tr.kernels or not name.endswith(ctx["mode"]):
        return None
    return len(tr.kernels) / ctx["trace_scans"]
