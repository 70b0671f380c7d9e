"""The layer spans of lidarseg3d_torch (``utils/spans.py``): with no
profiler collecting, ``span`` makes no call into torch's profiler; under
one, a train step of the mini SegNet and an eval step of the mini MSeg3D
record their layers as ``lidarseg3d::<layer>`` ranges, nested as the
layers are (the sparse convs' backward inside the step's backward), and
the outputs are the same bit for bit with the profiler on or off; every
name the package passes to ``span`` is one of ``spans.NAMES``."""

import ast
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lidarseg3d_torch.apis import train as api
from lidarseg3d_torch.models import build_detector
from lidarseg3d_torch.ops import cuda_build
from lidarseg3d_torch.solver.optim import build_one_cycle_optimizer
from lidarseg3d_torch.tools.test import input_shape_of, model_config
from lidarseg3d_torch.tools.warm_cache import synthetic_example
from lidarseg3d_torch.utils import spans
from lidarseg3d_torch.utils.config import Config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(ROOT, "lidarseg3d_torch")
SEGNET = os.path.join(ROOT, "configs", "tests", "mini_semkitti_segnet.py")
MSEG3D = os.path.join(ROOT, "configs", "tests", "mini_semkitti_mseg3d.py")
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(config, B=2):
    """(model, train state, optimizer, host batch, input shape) of a mini
    config on the CPU."""
    cuda_build.build(list(cuda_build.HOST_SOURCES))
    cfg = Config.fromfile(config)
    model = build_detector(model_config(cfg), device=CPU, seed=0)
    tx, _ = build_one_cycle_optimizer(dict(cfg.optimizer),
                                      dict(cfg.lr_config), total_steps=100,
                                      grad_clip=35.0)
    state = api.create_train_state(model, tx, seed=1)
    return model, state, tx, synthetic_example(cfg, B), input_shape_of(cfg)


def _ranges(prof):
    """The session's ``lidarseg3d::`` ranges as (layer, start, end) in ns,
    in the order they opened."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(spans.PREFIX):
            s = e.start_ns()
            out.append((e.name()[len(spans.PREFIX):], s,
                        s + e.duration_ns()))
    return sorted(out, key=lambda r: r[1])


def _inside(child, parents):
    return any(p[1] <= child[1] and child[2] <= p[2] for p in parents)


def _of(ranges, name):
    return [r for r in ranges if r[0] == name]


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _ranges(prof)


def test_span_off_makes_no_profiler_call(monkeypatch):
    calls = []
    real = spans._range

    def counted(*args, **kwargs):
        calls.append(args)
        return real(*args, **kwargs)

    def never(*args, **kwargs):
        raise AssertionError("a profiler range opened with none running")

    monkeypatch.setattr(spans, "_range", counted)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", never)
    model, state, tx, ex, shape = _setup(SEGNET)
    assert not torch.autograd.profiler._is_profiler_enabled
    assert spans.span("step") is spans.span("backward")  # the shared no-op
    step = api.make_train_step(model, tx, shape)
    state, ldict = step(state, api.example_to_device(ex, CPU))
    assert torch.isfinite(ldict["loss"])
    api.make_eval_step(model, shape)(state, api.example_to_device(ex, CPU))
    assert calls == []
    # and under a profiler the same helper does call it
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("step"):
            pass
    assert calls == [("lidarseg3d::step",)]
    # an operator-scope record: no user annotation, so no device shadow
    events = prof.profiler.kineto_results.events()
    (kind,) = [e.activity_type() for e in events
               if e.name() == "lidarseg3d::step"]
    assert kind == "cpu_op"


def test_train_step_records_each_layer_nested():
    model, state, tx, ex, shape = _setup(SEGNET)
    step = api.make_train_step(model, tx, shape)

    def run():
        batch = api.example_to_device(ex, CPU)
        return step(state, batch)

    (_, ldict), ranges = _profiled(run)
    assert torch.isfinite(ldict["loss"])
    names = {r[0] for r in ranges}
    assert names == {"to_device", "step", "reader", "rulebooks", "backbone",
                     "sparse_conv", "head", "backward", "optimizer"}
    (stp,) = _of(ranges, "step")
    (dev,) = _of(ranges, "to_device")
    assert dev[2] <= stp[1]  # the batch reaches the device before the step
    for name in ("reader", "rulebooks", "backbone", "head", "backward",
                 "optimizer"):
        assert all(_inside(r, [stp]) for r in _of(ranges, name)), name
    backbone, backward = _of(ranges, "backbone"), _of(ranges, "backward")
    assert len(backbone) == len(backward) == 1
    # the input structure before the backbone, the stages' inside it
    rbs = _of(ranges, "rulebooks")
    assert len(rbs) == 2 and rbs[0][2] <= backbone[0][1]
    assert _inside(rbs[1], backbone)
    # the forward and the backward of each of the UNet's 36 sparse convs
    convs = _of(ranges, "sparse_conv")
    fwd = [r for r in convs if _inside(r, backbone)]
    bwd = [r for r in convs if _inside(r, backward)]
    assert len(fwd) == len(bwd) == 36 and len(convs) == 72
    # the loss's head range lies before the backward, the update after it
    heads = _of(ranges, "head")
    assert len(heads) == 2 and heads[-1][2] <= backward[0][1]
    (opt,) = _of(ranges, "optimizer")
    assert backward[0][2] <= opt[1]


def test_eval_step_records_the_image_branch_and_head():
    model, state, _, ex, shape = _setup(MSEG3D, B=1)
    estep = api.make_eval_step(model, shape)
    batch = api.example_to_device(ex, CPU)
    _, ranges = _profiled(lambda: estep(state, batch))
    (stp,) = _of(ranges, "step")
    for name in ("image_branch", "head", "reader", "rulebooks", "backbone",
                 "sparse_conv"):
        got = _of(ranges, name)
        assert got and all(_inside(r, [stp]) for r in got), name
    assert {r[0] for r in ranges} == {
        "step", "image_branch", "reader", "rulebooks", "backbone",
        "sparse_conv", "head"}
    # the point head's forward and the prediction
    assert len(_of(ranges, "head")) == 2
    assert len(_of(ranges, "sparse_conv")) == 36


def test_outputs_are_the_same_with_the_profiler_on():
    model, state, _, ex, shape = _setup(MSEG3D, B=1)
    estep = api.make_eval_step(model, shape)
    batch = api.example_to_device(ex, CPU)
    off = estep(state, batch)
    on, ranges = _profiled(lambda: estep(state, batch))
    assert ranges
    assert sorted(off) == sorted(on)
    for k in off:
        assert torch.equal(off[k], on[k]), k


def _span_names(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "span"):
            assert len(node.args) == 1 and isinstance(
                node.args[0], ast.Constant), f"{path}:{node.lineno}"
            yield node.args[0].value


def test_every_span_name_is_listed():
    used = set()
    for dirpath, _, files in os.walk(PACKAGE):
        for f in files:
            if f.endswith(".py"):
                used.update(_span_names(os.path.join(dirpath, f)))
    assert used <= set(spans.NAMES), used - set(spans.NAMES)
    assert used == set(spans.NAMES)  # and each listed layer is opened
    assert len(spans.NAMES) == len(set(spans.NAMES))
