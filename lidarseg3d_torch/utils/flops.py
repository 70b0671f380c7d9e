"""Parameter and FLOP counting (the port's counterpart of
lidarseg3d_tpu/utils/flops.py, which reads XLA's cost analysis).

``count_flops`` runs the function once under
``torch.utils.flop_counter.FlopCounterMode`` for the dense operations
(matmuls, convolutions, ...) and counts the sparse convolutions from the
rulebooks the run built: the rulebook conv reaches its CUDA kernel
through ctypes, which the flop counter cannot see, so every call of
``ops.rulebook_conv.rulebook_conv`` adds 2 * hits * Cin * Cout for each
tap, hits being the rows that tap's rulebook gives an input row (a miss
multiplies nothing). On the CPU the same call runs its plain version,
whose matmuls the counter would see; those are taken out again, so both
devices count the same work.
"""

import torch
from torch.utils.flop_counter import FlopCounterMode


def count_params(model):
    """The number of parameter entries of a module (or of an iterable of
    tensors, or a dict of them)."""
    if isinstance(model, torch.nn.Module):
        tensors = model.parameters()
    elif isinstance(model, dict):
        tensors = model.values()
    else:
        tensors = model
    return sum(int(t.numel()) for t in tensors)


def count_flops(fn, *args):
    """-> {"flops", "dense_flops", "rulebook_conv_flops"} of one call
    ``fn(*args)``."""
    from ..ops import rulebook_conv as rc

    counter = FlopCounterMode(display=False)
    sparse = [0, 0]  # kernel work; the plain version's counted matmuls
    original = rc.rulebook_conv

    def counted(feat, rb, w, flip_taps=False, w_t=False, miss=None,
                zero_row=False):
        miss_row = feat.shape[0] - 1 if miss is None else miss
        cin = feat.shape[1]
        cout = w.shape[1 if w_t else 2]
        hits = (rb != miss_row).reshape(rb.shape[0], -1).sum(1)
        sparse[0] += int(2 * hits.sum()) * cin * cout
        before = counter.get_total_flops()
        out = original(feat, rb, w, flip_taps, w_t, miss, zero_row)
        sparse[1] += counter.get_total_flops() - before
        return out

    # the wrapper counts its launches on the module's name
    counted.launches = original.launches
    rc.rulebook_conv = counted
    try:
        with counter:
            fn(*args)
    finally:
        rc.rulebook_conv = original
        original.launches = counted.launches
    dense = counter.get_total_flops() - sparse[1]
    return {"flops": dense + sparse[0], "dense_flops": dense,
            "rulebook_conv_flops": sparse[0]}


def model_complexity(model, example):
    """(params, FLOPs) of a detector's evaluation forward on
    ``example``."""
    model.eval()
    stats = count_flops(lambda ex: model(ex), example)
    stats["params"] = count_params(model)
    return stats
