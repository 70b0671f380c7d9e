"""mfu_pct.<mode>: the model's FLOPs over the measured window's time, as a
share of 495 TFLOP/s (an H100's dense TF32 rate, the fastest at which
fp32-accurate arithmetic can run). The FLOPs of each pool batch are
counted by torch.utils.flop_counter over the benchmark's reference
(forward, and backward for training; its sparse convs count only the
rows with a partner), and summed over the batches the window ran."""


def read(ctx, name):
    flops = ctx.get("pool_flops")
    if flops is None or not name.endswith(ctx["mode"]):
        return None
    total = sum(flops[b] for b in ctx["window_ids"])
    return 100.0 * total / ctx["window_s"] / ctx["peak_flops"]
