"""layer_idle_pct.<layer>.<mode>: one layer's part of ``idle_pct.<mode>``:
that share (as ``idle_pct.py`` reads it) times the part of the traced
window's idle seconds whose gap has the layer as the innermost range of
the program open on the host at its middle (``layer_ms.py`` says which
range is innermost). The gaps are those ``segbench.trace.breakdown`` names
by host operation: between the window's edges and the device's busy
intervals. A gap with no range of the program open goes to the layer
``unspanned``, so the parts of every layer the window opens, with
``unspanned``, sum to ``idle_pct.<mode>``. None where the trace holds no
device activity, no idle time, no range of the program, or none of this
layer."""

from pathlib import Path

from segbench import spec

METRICS = Path(__file__).resolve().parent
_layer_ms = spec.metric_reader("layer_ms", METRICS.parent)
_idle_pct = spec.metric_reader("idle_pct", METRICS.parent)


def idle_seconds(tr, spans):
    """{layer: idle seconds of the gaps whose middle it holds}."""
    t0, t1 = tr.span
    edges = [t0] + [t for iv in tr.busy_intervals() for t in iv] + [t1]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    parts = {}
    for (a, b), layer in zip(gaps, _layer_ms.innermost(
            spans, [0.5 * (a + b) for a, b in gaps])):
        parts[layer] = parts.get(layer, 0.0) + (b - a) / 1e6
    return parts


def read(ctx, name):
    tr = ctx.get("trace")
    _, layer, mode = name.split(".")
    if tr is None or not tr.device or mode != ctx["mode"]:
        return None
    spans = _layer_ms.program_spans(tr)
    if not spans or (layer != _layer_ms.OUTSIDE
                     and layer not in {sp[2] for sp in spans}):
        return None
    parts = idle_seconds(tr, spans)
    total = sum(parts.values())
    if total <= 0:
        return None
    idle = _idle_pct.read(ctx, "idle_pct." + mode)
    return idle * parts.get(layer, 0.0) / total
