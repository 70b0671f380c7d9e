"""infer_scans_per_s: scans labelled in the window (a TTA frame counts
once) over the window's time."""


def read(ctx, name):
    if ctx["mode"] != "infer":
        return None
    return ctx["scans"] / ctx["window_s"]
