"""peak_mem_gib.<mode>: torch.cuda.max_memory_allocated() over the
measured window, after reset_peak_memory_stats() at its start."""


def read(ctx, name):
    if not name.endswith(ctx["mode"]) or not ctx.get("peak_bytes"):
        return None
    return ctx["peak_bytes"] / 2**30
