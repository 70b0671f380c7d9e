"""The readers of the program's layer ranges, ``metrics/layer_ms.py`` and
``metrics/layer_idle_pct.py``: on a made-up trace with nested
``lidarseg3d::`` ranges (one of them opened inside the backward), kernels
with launch times, idle gaps and a gap outside every range, each kernel
goes to exactly one layer, the layers' kernel time with that of the
kernels outside every range is the window's, and the layers' idle parts
sum to ``idle_pct``; both readers read nothing without a trace, for a
mode they do not serve, or from a program that opens no range; and a
traced run of the CPU-sized cell still completes, its trace holding the
ranges of every layer of a train step."""

import time

import pytest
import torch
from mini import BENCH, mini_plan

from segbench import cell, spec, trace

LAYER_MS = spec.metric_reader("layer_ms", BENCH)
IDLE = spec.metric_reader("layer_idle_pct", BENCH)
IDLE_PCT = spec.metric_reader("idle_pct", BENCH)
SEED = 2**31 + 4099
P = "lidarseg3d::"


def made_up_trace():
    """Times in us. The host's first and last operations make the window
    [0, 120]; a copy keeps the device busy over [6, 8]."""
    tr = trace.Trace()
    # the program's ranges are host operations to trace.read
    tr.host = [(s, e, n, 0) for s, e, n in [
        (2, 8, P + "to_device"), (10, 100, P + "step"),
        (12, 19, P + "reader"),
        (22, 60, P + "backbone"), (23, 30, P + "rulebooks"),
        (31, 35, P + "sparse_conv"), (40, 44, P + "sparse_conv"),
        (61, 69, P + "head"), (71, 90, P + "backward"),
        (75, 81, P + "sparse_conv"),  # the conv's backward, another thread
        (91, 99, P + "optimizer"),
        (0, 1, "aten::empty"), (118, 120, "cudaDeviceSynchronize")]]
    tr.annotations = [(12, 14, "segbench::image_branch")]
    # (launch us, start, end): the launches' innermost layers, in order
    launches = [(3, 3, 5), (11, 11, 12), (13, 13, 16), (24, 24, 26),
                (32, 32, 40), (50, 50, 52), (62, 62, 64), (76, 76, 80),
                (85, 85, 86), (95, 95, 97), (105, 105, 106)]
    for corr, (t, s, e) in enumerate(launches):
        tr.kernels.append((s, e, f"k{corr}", corr, -1))
        tr.runtime[corr] = t
        tr.device.append((s, e))
    tr.kernels.append((108, 110, "unknown launch", 99, 98))
    tr.device += [(108, 110), (6, 8)]
    return tr


def ctx_of(tr, mode="train"):
    return dict(mode=mode, trace=tr, trace_scans=4, trace_ids=[0, 1],
                window_s=0.5, window_ids=list(range(8000)))


def brute_innermost(tr, t):
    """The layer of the latest-opened program range holding ``t``."""
    live = [(s, n) for s, e, n, _ in tr.host
            if n.startswith(P) and s <= t <= e]
    return max(live)[1][len(P):] if live else "unspanned"


NAMES = ("to_device", "step", "reader", "rulebooks", "backbone",
         "sparse_conv", "head", "backward", "optimizer")


def test_each_kernel_goes_to_one_layer_and_the_parts_sum():
    tr = made_up_trace()
    parts = LAYER_MS.kernel_seconds(tr, LAYER_MS.program_spans(tr))
    assert parts == pytest.approx({
        "to_device": 2e-6, "step": 1e-6, "reader": 3e-6, "rulebooks": 2e-6,
        "sparse_conv": 12e-6, "backbone": 2e-6, "head": 2e-6,
        "backward": 1e-6, "optimizer": 2e-6, "unspanned": 3e-6})
    brute = {}  # each kernel's layer found by a brute force
    for k in tr.kernels:
        t = tr.kernel_launch_time(k)
        layer = "unspanned" if t is None else brute_innermost(tr, t)
        brute[layer] = brute.get(layer, 0.0) + (k[1] - k[0]) / 1e6
    assert parts == pytest.approx(brute)
    ctx = ctx_of(tr)
    read = {n: LAYER_MS.read(ctx, f"layer_ms.{n}.train") for n in NAMES}
    total = sum(e - s for s, e, *_ in tr.kernels) * 1e-3 / 4
    assert sum(read.values()) + parts["unspanned"] * 1e3 / 4 == \
        pytest.approx(total, rel=1e-12)
    assert read["sparse_conv"] == pytest.approx(12e-3 / 4)


def test_idle_parts_sum_to_idle_pct():
    tr = made_up_trace()
    parts = IDLE.idle_seconds(tr, LAYER_MS.program_spans(tr))
    # gaps: [0,3] [5,6] [8,11] [12,13] [16,24] [26,32] [40,50] [52,62]
    # [64,76] [80,85] [86,95] [97,105] [106,108] [110,120]
    assert parts == pytest.approx({
        "unspanned": 3e-6 + 3e-6 + 8e-6 + 2e-6 + 10e-6,
        "to_device": 1e-6, "reader": 1e-6, "step": 8e-6 + 12e-6 + 9e-6,
        "rulebooks": 6e-6, "backbone": 10e-6 + 10e-6, "backward": 5e-6})
    ctx = ctx_of(tr)
    idle = IDLE_PCT.read(ctx, "idle_pct.train")
    read = [IDLE.read(ctx, f"layer_idle_pct.{n}.train")
            for n in NAMES + ("unspanned",)]
    assert [r is None for r in read] == [False] * len(read)
    assert sum(read) == pytest.approx(idle, abs=1e-9)
    assert read[-1] == pytest.approx(idle * 26 / 88)


def test_readers_read_nothing_without_their_trace():
    tr = made_up_trace()
    for reader, family in ((LAYER_MS, "layer_ms"), (IDLE, "layer_idle_pct")):
        assert reader.read(dict(ctx_of(tr), trace=None),
                           f"{family}.step.train") is None
        # a mode the run does not serve
        assert reader.read(ctx_of(tr, "infer"),
                           f"{family}.step.train") is None
        # a layer the program did not open
        assert reader.read(ctx_of(tr), f"{family}.image_branch.train") \
            is None
        # a program that opens no range (nor a range outside them)
        bare = made_up_trace()
        bare.host = [h for h in bare.host if not h[2].startswith(P)]
        for layer in ("step", "unspanned"):
            assert reader.read(ctx_of(bare),
                               f"{family}.{layer}.train") is None
        # a trace without device activity (the CPU's)
        cpu = made_up_trace()
        cpu.kernels, cpu.device = [], []
        assert reader.read(ctx_of(cpu), f"{family}.step.train") is None


def test_traced_cpu_run_completes_with_the_ranges(tmp_path, cpu_threads,
                                                  monkeypatch):
    traces = []
    real = cell.traced_window

    def kept(*args, **kwargs):
        out = real(*args, **kwargs)
        traces.append(out[0])
        return out

    monkeypatch.setattr(cell, "traced_window", kept)
    plan = mini_plan("sdseg3d-semkitti.train", tmp_path)
    res = cell.run(plan, SEED, 0.3, True, torch.device("cpu"),
                   time.perf_counter(), log=lambda m: None)
    assert res["correct"], res["checks"]
    # no device activity on the CPU, so no layer metric is read
    assert not [n for n in res["metrics"] if n.startswith("layer_")]
    (tr,) = traces
    layers = {n for _, _, n in LAYER_MS.program_spans(tr)}
    assert layers == set(NAMES)
