"""layer_ms.<layer>.<mode>: device milliseconds a scan (a TTA frame counts
once) of the traced window's kernels put down to one layer of the
program. The port opens a profiler range ``lidarseg3d::<layer>`` around
each layer's work (``lidarseg3d_torch/utils/spans.py``), an operator-scope
record that ``segbench.trace`` files among the host's operations; a
kernel belongs to the innermost such range open at its launch
(``Trace.kernel_launch_time``): of the ranges open then, on any thread,
the one that opened last. So every kernel counts once, and the layers
plus the kernels launched outside every range sum to the window's kernel
time. A range's self time is its own kernels: ``backbone`` holds the norms,
activations and glue between the sparse convs, ``backward`` the autograd
of the dense layers. None where the trace holds no device kernel, no
range of the program, or none of this layer."""

PREFIX = "lidarseg3d::"
OUTSIDE = "unspanned"  # launched, or idle, with no range of the program open


def program_spans(tr):
    """The trace's ranges of the program as (start us, end us, layer), in
    the order they opened."""
    return sorted((s, e, n[len(PREFIX):]) for s, e, n, _ in tr.host
                  if n.startswith(PREFIX))


def innermost(spans, times):
    """For each of ``times`` (us, ascending), the layer of the latest-opened
    range of ``spans`` still open then, or OUTSIDE."""
    out, live, i = [], [], 0
    for t in times:
        while i < len(spans) and spans[i][0] <= t:
            live.append(spans[i])
            i += 1
        live = [sp for sp in live if sp[1] >= t]  # in the order they opened
        out.append(live[-1][2] if live else OUTSIDE)
    return out


def kernel_seconds(tr, spans):
    """{layer (OUTSIDE for a kernel launched outside every range, or of
    unknown launch): device seconds of its kernels}."""
    launched = sorted(
        (float("inf") if t is None else t, k[1] - k[0])
        for k in tr.kernels for t in (tr.kernel_launch_time(k),))
    parts = {}
    for (_, d), layer in zip(launched, innermost(
            spans, [t for t, _ in launched])):
        parts[layer] = parts.get(layer, 0.0) + d / 1e6
    return parts


def read(ctx, name):
    tr = ctx.get("trace")
    _, layer, mode = name.split(".")
    if tr is None or not tr.kernels or mode != ctx["mode"]:
        return None
    spans = program_spans(tr)
    if layer not in {sp[2] for sp in spans}:
        return None
    secs = kernel_seconds(tr, spans).get(layer, 0.0)
    return secs * 1e3 / ctx["trace_scans"]
