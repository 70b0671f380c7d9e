"""image_branch_ms.<mode>: device milliseconds a scan of the kernels
launched inside the forward of the image branch's modules (the
configuration's ``img_backbone`` and ``img_head``, which the segmentor
holds as ``img_backbone_mod`` and ``img_head_mod``), in the traced
window. Forward hooks of the benchmark open a profiler range around each
module's forward; a kernel belongs to the branch when its launch lies in
one."""

LABEL = "segbench::image_branch"
MODULES = ("img_backbone_mod", "img_head_mod")


def instrument(ctx):
    import torch

    handles = []
    for attr in MODULES:
        mod = getattr(ctx["model"], attr, None)
        if mod is None:
            continue
        ranges = []

        def enter(m, args, ranges=ranges):
            rf = torch.autograd.profiler.record_function(LABEL)
            rf.__enter__()
            ranges.append(rf)

        def leave(m, args, out, ranges=ranges):
            ranges.pop().__exit__(None, None, None)

        handles.append(mod.register_forward_pre_hook(enter))
        handles.append(mod.register_forward_hook(leave))
    return handles


def read(ctx, name):
    from segbench import trace

    tr = ctx.get("trace")
    if tr is None or not name.endswith(ctx["mode"]):
        return None
    secs = trace.kernel_time_in(tr, LABEL)
    return None if secs is None else secs * 1e3 / ctx["trace_scans"]
