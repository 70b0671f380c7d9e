"""HRNet's frozen stages in training: one whole train step of
lidarseg3d_torch (apis.train.make_train_step) against the JAX package's
make_train_step on configs/tests/mini_semkitti_mseg3d.py with
``frozen_stages=3`` and ``norm_eval`` False (True in
test_torch_port_hrnet_norm_eval.py, which runs these tests on its own
step), from the same random Flax variables and the same labelled batch
(B=1, V=N=512, one 64x128 camera, DP_RATIO=0 on both sides: the
frameworks draw different dropout masks). Freezing does not depend on the
batch's size; tracing and compiling the JAX step take nearly all of the
time, whatever the size. The JAX HRNet runs with ``s2d_max_c=0``: its
space-to-depth layout is an exact rewrite of the same convolutions (the
port has none), and at the mini config's 4-16 channels it doubles the
time JAX takes to trace the step.

What freezing means here is the JAX package's (hrnet.py:362-403): the stem
and stages 1-3 run BN on running statistics and pass no gradient back, yet
their parameters stay in the optimizer, whose decoupled weight decay
(wd=0.01 on every parameter) still shrinks them each step.

Tolerances, those of test_torch_port_train_step.py (fp32, another order of
summation than XLA):
- every loss term and grad_norm within 1e-4 relative;
- the gradients of the frozen parameters exactly zero on both sides, and
  the BN statistics of the frozen parts (with norm_eval, of the whole
  image backbone) bit-unchanged on both sides;
- every other gradient within 2e-2 of its largest reference entry and 1e-2
  in relative L2 norm, plus 1e-8 * grad_norm absolute;
- every parameter after the step within 2 * lr, and within 1e-2 * lr where
  |g| >= 1e-5; a frozen parameter, on both sides, p * (1 - lr * wd) within
  2.5e-7 of |p| (two fp32 ulps; the decay itself is 1e-6 of |p|)."""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from __graft_entry__ import _synthetic_mseg3d_batch
from lidarseg3d_tpu.apis import train as jtrain
from lidarseg3d_tpu.models import build_detector as jbuild
from lidarseg3d_tpu.solver.optim import build_one_cycle_optimizer as jbuild_opt
from lidarseg3d_torch import synthetic as syn
from lidarseg3d_torch.apis import train as ttrain
from lidarseg3d_torch.convert import (flax_params_to_named, flax_to_state_dict,
                                      load_flax_variables)
from lidarseg3d_torch.models import build_detector as tbuild
from lidarseg3d_torch.solver.optim import build_one_cycle_optimizer as tbuild_opt

from _torch_port_helpers import init_shapes, random_variables
from test_torch_port_support import mini_config, one_torch_thread

B, V, N, IMG = 1, 512, 512, (64, 128)
OPT = dict(type="adam", wd=0.01)
LR = dict(lr_max=1e-3, moms=(0.95, 0.85), div_factor=10.0, pct_start=0.4)
TOTAL, CLIP = 10, 35.0
REL_LOSS, REL_GRAD, REL_GRAD_L2 = 1e-4, 2e-2, 1e-2
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def mini_model_cfg(frozen_stages=3, norm_eval=False):
    cfg = mini_config()
    model = copy.deepcopy(cfg.model.to_dict())
    model["img_backbone"].update(frozen_stages=frozen_stages,
                                 norm_eval=norm_eval, s2d_max_c=0)
    model["point_head"]["model_cfg"]["DP_RATIO"] = 0
    return cfg, model


def train_step_pair(norm_eval):
    """One JAX and one port train step from the same variables and batch:
    losses, gradients, parameters and statistics of both sides."""
    cfg, model_cfg = mini_model_cfg(norm_eval=norm_eval)
    pcr, vsz = cfg.point_cloud_range, cfg.voxel_size
    ishape = syn.grid_shape(pcr, vsz)
    jb = _synthetic_mseg3d_batch(B, V, N, img_hw=IMG, seed=5,
                                 with_labels=True, pcr=pcr, vsz=vsz)
    jm = jbuild(copy.deepcopy(model_cfg))
    jex = {k: jnp.asarray(jb[k]) for k in jtrain.DEVICE_BATCH_KEYS}
    variables = random_variables(
        init_shapes(jm, dict(jex, input_shape=ishape), train=False), seed=1)
    tx, _ = jbuild_opt(OPT, LR, TOTAL, grad_clip=CLIP)
    state = jtrain.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]))
    # XLA's cheapest CPU compile: the same step, compiled in about four
    # fifths of the time
    step = jax.jit(jtrain.make_train_step(jm, tx, ishape)).lower(
        state, jex).compile(compiler_options=FAST_COMPILE)
    new_state, jl = step(state, jex)
    jl = {k: float(v) for k, v in jl.items()}

    tb = syn.synthetic_mseg3d_batch(B, V, N, img_hw=IMG, seed=5,
                                    with_labels=True, pcr=pcr, vsz=vsz)
    tm = tbuild(copy.deepcopy(model_cfg), device="cpu")
    load_flax_variables(tm, variables)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    opt, tlr = tbuild_opt(OPT, LR, TOTAL, grad_clip=CLIP)
    tstate = ttrain.create_train_state(tm, opt)
    step = ttrain.make_train_step(tm, opt, ishape)
    tstate, tl = step(tstate, ttrain.example_to_device(tb, "cpu"))

    assert jl["grad_norm"] < CLIP
    b1 = float(new_state.opt_state.hyperparams["b1"])
    mu = new_state.opt_state.inner_state[1].mu
    jgrads = flax_params_to_named(
        tm, jax.tree_util.tree_map(lambda m: np.asarray(m) / (1.0 - b1), mu))
    jnew = flax_to_state_dict(tm, {
        "params": jax.tree_util.tree_map(np.asarray, new_state.params),
        "batch_stats": jax.tree_util.tree_map(np.asarray,
                                              new_state.batch_stats)})
    return dict(norm_eval=norm_eval, jl=jl,
                tl={k: float(v) for k, v in tl.items()}, jgrads=jgrads,
                jnew=jnew, tm=tm, before=before, lr0=tlr(0))


@pytest.fixture(scope="module", params=[False], ids=["norm_eval=False"])
def run(request):
    return train_step_pair(request.param)


def test_frozen_parameters_are_all_but_stage_4(run):
    hb = run["tm"].img_backbone_mod
    trans, stack = hb.stages[-1]
    stage4 = {id(p) for m in [t for t in trans if t is not None] + [stack]
              for p in m.parameters()}
    frozen = set(run["tm"].frozen_parameters())
    for n, p in run["tm"].named_parameters():
        if n.startswith("img_backbone_mod."):
            assert (n in frozen) == (id(p) not in stage4), n
        else:
            assert n not in frozen, n


def test_loss_terms_match(run):
    assert set(run["tl"]) == set(run["jl"])
    for k, want in run["jl"].items():
        assert np.isfinite(run["tl"][k]), k
        assert abs(run["tl"][k] - want) <= REL_LOSS * abs(want), (
            k, run["tl"][k], want)


def test_frozen_gradients_are_exactly_zero_and_others_match(run):
    named = dict(run["tm"].named_parameters())
    frozen = set(run["tm"].frozen_parameters())
    atol = 1e-8 * run["jl"]["grad_norm"]
    for k, want in run["jgrads"].items():
        got = named[k].grad
        assert got is not None and torch.isfinite(got).all(), k
        if k in frozen:
            assert not got.any() and not want.any(), k
            continue
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        assert err <= REL_GRAD * scale + atol, (k, err, scale)
        if scale > 10 * atol:
            l2 = float((got - want).norm() / want.norm())
            assert l2 <= REL_GRAD_L2, (k, l2)


def test_frozen_bn_statistics_do_not_move(run):
    tm, before, jnew = run["tm"], run["before"], run["jnew"]
    hb = tm.img_backbone_mod
    names = {id(m): n for n, m in hb.named_modules()}
    parts = [hb] if run["norm_eval"] else hb.frozen_parts()
    frozen_stats = {f"img_backbone_mod.{names[id(m)]}.{b}"
                    for part in parts for m in part.modules()
                    if hasattr(m, "running_mean")
                    for b in ("running_mean", "running_var")}
    assert frozen_stats
    sd = tm.state_dict()
    for k in frozen_stats:
        assert torch.equal(sd[k], before[k]), k
        assert torch.equal(jnew[k], before[k]), k
    moved = [k for k in sd if k.endswith("running_mean")
             and k not in frozen_stats and not torch.equal(sd[k], before[k])]
    assert moved  # the lidar branch and the head still train their BN


def test_parameters_after_the_step_match(run):
    tm, lr = run["tm"], run["lr0"]
    frozen = set(tm.frozen_parameters())
    named = dict(tm.named_parameters())
    for k, p in named.items():
        got, want, old = p.detach(), run["jnew"][k], run["before"][k]
        d = (got - want).abs()
        assert float(d.max()) <= 2.0 * lr + 1e-7, (k, float(d.max()))
        firm = run["jgrads"][k].abs() >= 1e-5
        if firm.any():
            assert float(d[firm].max()) <= 1e-2 * lr, k
        if k in frozen:
            # zero gradient: Adam's update is 0, weight decay alone moves
            # the parameter, by lr * wd = 1e-6 of itself (~16 fp32 ulps)
            decayed = old.double() * (1.0 - lr * OPT["wd"])
            ulps = 2.5e-7 * old.double().abs() + 1e-30
            assert ((got.double() - decayed).abs() <= ulps).all(), k
            assert ((want.double() - decayed).abs() <= ulps).all(), k
            assert not torch.equal(got, old), k
