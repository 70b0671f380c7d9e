"""One whole train step of lidarseg3d_torch (apis.train.make_train_step:
forward in training mode, losses, backward through RulebookConvFn, clip /
Adam / weight decay / OneCycle) against the JAX package's make_train_step,
on _mseg3d_model_cfg(ratio=1, small_hrnet=True) with DP_RATIO=0 on both
sides (the two frameworks draw different dropout masks), B=2, V=N=1024 and
a 64x128 camera, from the same random Flax variables and the same labelled
batch.

Tolerances (fp32; every stage sums in another order than XLA, and batch
statistics feed every layer's rounding forward):
- every loss term and grad_norm within 1e-4 relative;
- every gradient tensor within 2e-2 of its largest reference entry and
  within 1e-2 in relative L2 norm, plus 1e-8 * grad_norm absolute for the
  tensors whose gradient is analytically zero (a bias in front of a BN, an
  attention key bias: ~1e-9 of rounding noise on both sides). The bound is
  set by the reference's own fp32 noise: against a float64 run of the port
  on the same inputs, the JAX gradients are off by up to 9.4e-3 of the max
  (point_head TorchLinear_1.weight, in front of a BN with eps 1e-6) where
  the port's fp32 gradients are off by 1.8e-3; most tensors agree to 1e-3.
  The reference gradient is read from the JAX train state's first Adam
  moment, mu = (1 - b1) * g, which holds for the first step while the
  clip is inactive (asserted);
- BN running statistics within 1e-4 of their largest entry;
- updated parameters: Adam's first update is lr * g / (|g| + 1e-8), the
  sign of g where |g| >> 1e-8, so an entry whose gradient is analytically
  zero (a bias in front of a BN) may land anywhere within +-lr on either
  side. Entries with |g| >= 1e-5 must agree within 1e-2 * lr, every entry
  within 2 * lr."""

import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from __graft_entry__ import (_grid_shape, _mseg3d_model_cfg,
                             _synthetic_mseg3d_batch)
from lidarseg3d_tpu.apis import train as jtrain
from lidarseg3d_tpu.models import build_detector as jbuild
from lidarseg3d_tpu.solver.optim import build_one_cycle_optimizer as jbuild_opt
from lidarseg3d_torch import synthetic as syn
from lidarseg3d_torch.apis import train as ttrain
from lidarseg3d_torch.convert import flax_params_to_named, load_flax_variables
from lidarseg3d_torch.models import build_detector as tbuild
from lidarseg3d_torch.solver.optim import build_one_cycle_optimizer as tbuild_opt

from _torch_port_helpers import assert_close_rel, init_shapes, n, random_variables
from test_torch_port_support import one_torch_thread  # noqa: F401

B, V, N, IMG = 2, 1024, 1024, (64, 128)
OPT = dict(type="adam", wd=0.01)
LR = dict(lr_max=1e-3, moms=(0.95, 0.85), div_factor=10.0, pct_start=0.4)
TOTAL, CLIP = 10, 35.0
REL_LOSS, REL_GRAD, REL_GRAD_L2, REL_STATS = 1e-4, 2e-2, 1e-2, 1e-4


def _cfg(make):
    cfg = make(ratio=1, small_hrnet=True)
    cfg["point_head"]["model_cfg"]["DP_RATIO"] = 0
    return cfg


@pytest.fixture(scope="module")
def run():
    jb = _synthetic_mseg3d_batch(B, V, N, img_hw=IMG, seed=5,
                                 with_labels=True)
    ishape = _grid_shape()
    jm = jbuild(_cfg(_mseg3d_model_cfg))
    jex = {k: jnp.asarray(jb[k]) for k in jtrain.DEVICE_BATCH_KEYS}
    variables = random_variables(
        init_shapes(jm, dict(jex, input_shape=ishape), train=False), seed=1)
    tx, jlr = jbuild_opt(OPT, LR, TOTAL, grad_clip=CLIP)
    state = jtrain.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]))
    t0 = time.perf_counter()
    new_state, jl = jax.jit(jtrain.make_train_step(jm, tx, ishape))(state,
                                                                    jex)
    jl = {k: float(v) for k, v in jl.items()}
    jax_seconds = time.perf_counter() - t0

    tb = syn.synthetic_mseg3d_batch(B, V, N, img_hw=IMG, seed=5,
                                    with_labels=True)
    tm = tbuild(_cfg(syn.mseg3d_model_cfg), device="cpu")
    load_flax_variables(tm, variables)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    opt, tlr = tbuild_opt(OPT, LR, TOTAL, grad_clip=CLIP)
    tstate = ttrain.create_train_state(tm, opt)
    step = ttrain.make_train_step(tm, opt, syn.grid_shape())
    tstate, tl = step(tstate, ttrain.example_to_device(tb, "cpu"))

    # the JAX gradient, from the first Adam moment (module docstring)
    assert jl["grad_norm"] < CLIP
    b1 = float(new_state.opt_state.hyperparams["b1"])
    mu = new_state.opt_state.inner_state[1].mu
    jgrads = flax_params_to_named(
        tm, jax.tree_util.tree_map(lambda m: np.asarray(m) / (1.0 - b1), mu))
    return dict(jl=jl, tl={k: float(v) for k, v in tl.items()},
                jgrads=jgrads, tm=tm, before=before, tstate=tstate,
                new_state=new_state, lr0=tlr(0), jlr0=float(jlr(0)),
                jax_seconds=jax_seconds)


def test_loss_terms_and_grad_norm_match(run):
    assert set(run["tl"]) == set(run["jl"])
    assert {"loss", "grad_norm", "voxel_ce_loss", "voxel_lovasz_loss",
            "out_ce_loss", "out_lovasz_loss", "out_mimic_loss",
            "image_ce_loss"} <= set(run["tl"])
    for k, want in run["jl"].items():
        assert np.isfinite(run["tl"][k]), k
        assert abs(run["tl"][k] - want) <= REL_LOSS * abs(want), (
            k, run["tl"][k], want)


def test_every_gradient_matches(run):
    named = dict(run["tm"].named_parameters())
    assert set(named) == set(run["jgrads"])
    atol = 1e-8 * run["jl"]["grad_norm"]
    worst, worst_l2 = ("", 0.0), ("", 0.0)
    for k, want in run["jgrads"].items():
        got = named[k].grad
        assert got is not None and torch.isfinite(got).all(), k
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        assert err <= REL_GRAD * scale + atol, (k, err, scale)
        if scale <= 10 * atol:
            continue
        l2 = float((got - want).norm() / want.norm())
        assert l2 <= REL_GRAD_L2, (k, l2)
        worst = max(worst, (k, err / scale), key=lambda kv: kv[1])
        worst_l2 = max(worst_l2, (k, l2), key=lambda kv: kv[1])
    print(f"worst gradient: {worst[0]} at {worst[1]:.2e} of its max; "
          f"{worst_l2[0]} at {worst_l2[1]:.2e} in relative L2")


def test_updated_parameters_match(run):
    new = flax_params_to_named(run["tm"], jax.tree_util.tree_map(
        np.asarray, run["new_state"].params))
    lr = run["lr0"]
    assert abs(lr - run["jlr0"]) <= 1e-6 * lr
    named = dict(run["tm"].named_parameters())
    for k, want in new.items():
        got = named[k].detach()
        d = (got - want).abs()
        assert float(d.max()) <= 2.0 * lr + 1e-7, (k, float(d.max()))
        firm = run["jgrads"][k].abs() >= 1e-5
        if firm.any():
            assert float(d[firm].max()) <= 1e-2 * lr, (k, float(d[firm].max()))
        assert not torch.equal(got, run["before"][k]), f"{k} did not move"
    assert run["tstate"].step == 1 and run["tstate"].opt_state.count == 1
    assert int(run["new_state"].step) == 1


def test_bn_running_statistics_match(run):
    from lidarseg3d_torch.convert import flax_to_state_dict

    want = flax_to_state_dict(run["tm"], {
        "params": jax.tree_util.tree_map(np.asarray,
                                         run["new_state"].params),
        "batch_stats": jax.tree_util.tree_map(
            np.asarray, run["new_state"].batch_stats)})
    sd = run["tm"].state_dict()
    stats = [k for k in sd if k.endswith(("running_mean", "running_var"))]
    assert len(stats) > 50
    for k in stats:
        assert_close_rel(sd[k], want[k], REL_STATS, k)
        assert not torch.equal(sd[k], run["before"][k]), f"{k} did not move"


def test_eval_step_after_training_predicts(run):
    tb = syn.synthetic_mseg3d_batch(B, V, N, img_hw=IMG, seed=5,
                                    with_labels=True)
    pred = ttrain.make_eval_step(run["tm"], syn.grid_shape())(
        run["tstate"], ttrain.example_to_device(tb, "cpu"))
    labels = n(pred["pred_point_sem_labels"])
    assert labels.shape == (B, N) and labels.min() >= 0 and labels.max() < 20
    assert not run["tm"].training
