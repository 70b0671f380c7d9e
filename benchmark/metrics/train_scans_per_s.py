"""train_scans_per_s: the scans of every training step of the window over
the window's time, which ends on a synchronisation."""


def read(ctx, name):
    if ctx["mode"] != "train":
        return None
    return ctx["scans"] / ctx["window_s"]
