"""The train step on 2 gloo ranks (CPU) of B=1 each against one process at
B=2 on the same two frames, and against the JAX package's
``make_train_step`` on them, for the mini MSeg3D config
(configs/tests/mini_semkitti_mseg3d.py, all HRNet stages training, the
point head's dropout on) and the mini SegNet config
(configs/tests/mini_semkitti_segnet.py: TransVFE, the batch-loss head's
CE and Lovász terms). The two frames come from a seeded tree through the
config's train pipeline and hold different numbers of valid points and
voxels. The JAX package's SPMD step over a sharded batch is the step over
the whole batch, so:

- 2 ranks x B=1 equal 1 process x B=2 (dropout on: every rank draws the
  global batch's mask and keeps its rows): every loss term and the
  gradient norm within 1e-4 relative, every gradient within 1e-4 of its
  largest entry (plus 1e-8 of the gradient norm for the tensors whose
  gradient is analytically zero), every BN running statistic within 1e-4
  of its largest entry, and the parameters after the step within 1e-2 *
  lr where |g| is at least 1e-5 and the gradient's limit, and 2 * lr
  everywhere (Adam's first update is lr * sign(g) where |g| >> 1e-8);
  in float64 (the same runs with the model and batch in float64) every
  gradient within 1e-9; MSeg3D's fp32 gradients, noisier than 1e-4
  between two summation orders, only in float64 (REL_GRAD);
- 2 ranks x B=1 equal JAX's step on the two frames, with DP_RATIO=0 on
  both sides (the two frameworks draw different masks): the limits of
  test_torch_port_train_step.py for MSeg3D (gradients within 2e-2 of
  their max and 1e-2 in relative L2 norm, the reference's own fp32 noise
  in front of the head's eps=1e-6 BN) and of test_torch_port_segnet.py
  for SegNet (1e-4 and 1e-4); the loss terms, BN statistics and
  parameters as above;
- the parameters and BN statistics are bit-identical on the two ranks
  after the first step and after three.

The JAX side runs its HRNet with ``s2d_max_c=0`` and its step compiled at
XLA's lowest optimisation level (test_torch_port_hrnet_frozen.py)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidarseg3d_tpu.apis import train as jtrain
from lidarseg3d_tpu.models import build_detector as jbuild
from lidarseg3d_tpu.solver.optim import build_one_cycle_optimizer as jbuild_opt
from lidarseg3d_torch.apis import train as ttrain
from lidarseg3d_torch.convert import (flax_params_to_named, flax_to_state_dict,
                                      load_flax_variables)
from lidarseg3d_torch.datasets import build_dataset
from lidarseg3d_torch.datasets.batching import collate_segnet
from lidarseg3d_torch.models import build_detector as tbuild
from lidarseg3d_torch.solver.optim import build_one_cycle_optimizer as tbuild_opt
from lidarseg3d_torch.synthetic import write_semantickitti_tree
from lidarseg3d_torch.tools.test import input_shape_of
from lidarseg3d_torch.utils.config import Config

from _torch_ddp import record_step, run_ranks, to_dtype, train_steps
from _torch_port_helpers import init_shapes, random_variables
from test_torch_port_support import MINI_CONFIG
from test_torch_port_support import one_torch_thread  # noqa: F401

CONFIGS = {"mseg3d": MINI_CONFIG,
           "segnet": MINI_CONFIG.replace("mseg3d", "segnet")}
OPT = dict(type="adam", wd=0.01)
LR = dict(lr_max=1e-3, moms=(0.95, 0.85), div_factor=10.0, pct_start=0.4)
TOTAL, CLIP, STEPS = 10, 35.0, 3
REL = 1e-4
REL_JAX_GRAD = {"mseg3d": (2e-2, 1e-2), "segnet": (1e-4, 1e-4)}
# 2 ranks against 1 process: (max |err| / max |want|, relative L2) of the
# gradients; in float64 the two agree to ~3e-13, so any difference in the
# step's arithmetic shows. MSeg3D's fp32 gradients differ between two
# summation orders by more than 1e-4: at these weights the two ranks'
# forward first leaves one process's by ~1e-4 at the point head's eps=1e-6
# BN of the camera features (few in-view points), and the gradients in
# front of it by up to ~6e-3 of a tensor's max and ~1.3e-2 in relative L2.
# So MSeg3D's gradients and updated parameters are held in float64, and in
# fp32 its loss terms, gradient norm and BN statistics
REL_GRAD = {("mseg3d", "float32"): (None, None),
            ("segnet", "float32"): (1e-4, 1e-4),
            ("mseg3d", "float64"): (1e-9, 1e-9),
            ("segnet", "float64"): (1e-9, 1e-9)}
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _frames(kind, tmp):
    """The config over a seeded two-frame tree, and the two frames through
    its train pipeline: (config, [B=1 batch of each frame], B=2 batch)."""
    root = str(tmp / "sequences")
    write_semantickitti_tree(root, ("00",), frames=2, points=(600, 900),
                             seed=21, image_hw=(64, 128), max_range=6.0)
    cfg = Config.fromfile(CONFIGS[kind])
    ds_cfg = cfg.data.train.to_dict()
    ds_cfg["root_path"] = root
    ds = build_dataset(ds_cfg)
    cap = cfg.capacity

    def frame(i):
        return ds.get_sensor_data(i, rng=np.random.default_rng(30 + i))

    def collate(ids):
        return collate_segnet([frame(i) for i in ids], cap["max_voxels"],
                              cap["max_points"], cfg.get("ignore_label", 0),
                              on_overflow="error")

    return cfg, [collate([0]), collate([1])], collate([0, 1])


def _model_cfg(cfg, kind, dropout):
    m = copy.deepcopy(cfg.model.to_dict())
    if kind == "mseg3d" and not dropout:
        m["point_head"]["model_cfg"]["DP_RATIO"] = 0
    return m


def _jax_step(cfg, kind, batch, ishape):
    jcfg = _model_cfg(cfg, kind, dropout=False)
    if kind == "mseg3d":
        jcfg["img_backbone"]["s2d_max_c"] = 0
    jm = jbuild(jcfg)
    jex = {k: jnp.asarray(batch[k]) for k in jtrain.DEVICE_BATCH_KEYS
           if k in batch}
    variables = random_variables(
        init_shapes(jm, dict(jex, input_shape=ishape), train=False), seed=1)
    tx, _ = jbuild_opt(OPT, LR, TOTAL, grad_clip=CLIP)
    state = jtrain.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]))
    step = jax.jit(jtrain.make_train_step(jm, tx, ishape)).lower(
        state, jex).compile(compiler_options=FAST_COMPILE)
    new_state, jl = step(state, jex)
    jl = {k: float(v) for k, v in jl.items()}
    assert jl["grad_norm"] < CLIP  # so mu = (1 - b1) g
    b1 = float(new_state.opt_state.hyperparams["b1"])
    return dict(variables=jax.tree_util.tree_map(np.asarray, variables),
                losses=jl, new_state=new_state,
                mu=jax.tree_util.tree_map(
                    lambda m: np.asarray(m) / (1.0 - b1),
                    new_state.opt_state.inner_state[1].mu))


@pytest.fixture(scope="module", params=["mseg3d", "segnet"])
def run(request, tmp_path_factory):
    kind = request.param
    tmp = tmp_path_factory.mktemp(f"ddp_{kind}")
    cfg, rows, batch = _frames(kind, tmp)
    ishape = input_shape_of(cfg)
    jx = _jax_step(cfg, kind, batch, ishape)

    tm = tbuild(_model_cfg(cfg, kind, dropout=True), device="cpu")
    load_flax_variables(tm, jx["variables"])
    first = {k: v.clone() for k, v in tm.state_dict().items()}
    one = {}
    for dtype in (torch.float32, torch.float64):
        tm.load_state_dict(first)
        tm.to(dtype)
        opt, lr = tbuild_opt(OPT, LR, TOTAL, grad_clip=CLIP)
        step = ttrain.make_train_step(tm, opt, ishape)
        _, ldict = step(ttrain.create_train_state(tm, opt), to_dtype(
            ttrain.example_to_device(batch, "cpu"), dtype))
        one[dtype] = record_step(tm, ldict)
    tm.to(torch.float32)

    drop = _model_cfg(cfg, kind, dropout=True)
    runs = {"dropout": (drop, STEPS, torch.float32),
            "float64": (drop, 1, torch.float64)}
    if kind == "mseg3d":
        runs["no_dropout"] = (_model_cfg(cfg, kind, dropout=False), 1,
                              torch.float32)
    job = dict(batches=rows, state=first, grid=ishape, runs=runs,
               optimizer=(OPT, LR, TOTAL), clip=CLIP)
    ranks = run_ranks(train_steps, 2, tmp / "ranks", job)
    jgrads = flax_params_to_named(tm, jx["mu"])
    jnew = flax_params_to_named(tm, jax.tree_util.tree_map(
        np.asarray, jx["new_state"].params))
    jstate = flax_to_state_dict(tm, {
        "params": jax.tree_util.tree_map(np.asarray,
                                         jx["new_state"].params),
        "batch_stats": jax.tree_util.tree_map(
            np.asarray, jx["new_state"].batch_stats)})
    return dict(kind=kind, rows=rows, first=first, one=one, ranks=ranks,
                lr=lr(0), jx=dict(losses=jx["losses"], grads=jgrads,
                                  params=jnew, state=jstate),
                named=[k for k, _ in tm.named_parameters()])


def _check(got, want, first, lr, named, rel_grad, rel_l2):
    """A step's record against the reference's (module docstring); prints
    the worst gradient error. ``rel_grad`` None: the gradients and the
    updated parameters are not compared (every parameter must move)."""
    assert set(got["losses"]) == set(want["losses"])
    for k, v in want["losses"].items():
        assert np.isfinite(got["losses"][k]), k
        assert abs(got["losses"][k] - v) <= REL * abs(v), (
            k, got["losses"][k], v)
    atol = 1e-8 * want["losses"]["grad_norm"]
    assert set(got["grads"]) == set(named)
    worst = ("", 0.0, 0.0)
    for k in named:
        assert not torch.equal(got["state"][k].to(first[k].dtype),
                               first[k]), f"{k} stayed"
        if rel_grad is None:
            continue
        g = got["grads"][k].double()
        w = torch.as_tensor(want["grads"][k]).double()
        scale = float(w.abs().max())
        lim, lim_l2 = rel_grad * scale + atol, rel_l2
        err = float((g - w).abs().max())
        assert err <= lim, (k, err, lim)
        if scale > 10 * atol:
            l2 = float((g - w).norm() / w.norm())
            assert l2 <= lim_l2, (k, l2, lim_l2)
            worst = max(worst, (k, err / scale, l2), key=lambda t: t[1])
        want_p = torch.as_tensor(want["state"][k]).double()
        d = (got["state"][k].double() - want_p).abs()
        assert float(d.max()) <= 2.0 * lr + 1e-7, (k, float(d.max()))
        # the sign of g, so the update, is settled where |g| exceeds the
        # gradient's limit
        firm = w.abs() >= max(1e-5, lim)
        if firm.any():
            assert float(d[firm].max()) <= 1e-2 * lr, k
    stats = [k for k in first if k.endswith(("running_mean", "running_var"))]
    assert stats
    for k in stats:
        w = torch.as_tensor(want["state"][k]).double()
        err = float((got["state"][k].double() - w).abs().max())
        assert err <= REL * float(w.abs().max()), (k, err)
    print(f"worst gradient: {worst[0]} at {worst[1]:.2e} of its max, "
          f"{worst[2]:.2e} in relative L2")


def test_frames_differ_in_valid_points_and_voxels(run):
    a, b = run["rows"]
    assert a["point_valid"].sum() != b["point_valid"].sum()
    assert a["num_voxels"][0] != b["num_voxels"][0]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_two_ranks_equal_one_process_at_twice_the_batch(run, dtype):
    name = "dropout" if dtype == "float32" else "float64"
    got = run["ranks"][0][name]
    _check(got, run["one"][getattr(torch, dtype)], run["first"], run["lr"],
           run["named"], *REL_GRAD[run["kind"], dtype])


def test_two_ranks_equal_jax_step(run):
    name = "no_dropout" if run["kind"] == "mseg3d" else "dropout"
    want = dict(run["jx"], state={**run["jx"]["state"], **run["jx"]["params"]})
    _check(run["ranks"][0][name], want, run["first"], run["lr"],
           run["named"], *REL_JAX_GRAD[run["kind"]])


def test_ranks_stay_bit_identical(run):
    r0, r1 = run["ranks"]
    for name in r0:
        for when in ("state", "last"):
            a, b = r0[name][when], r1[name][when]
            assert set(a) == set(b)
            for k in a:
                assert torch.equal(a[k], b[k]), (name, when, k)
        for k, g in r0[name]["grads"].items():
            assert torch.equal(g, r1[name]["grads"][k]), (name, k)
    k = run["named"][0]  # three steps went past the first
    assert not torch.equal(r0["dropout"]["last"][k], r0["dropout"]["state"][k])
