"""SegNet of lidarseg3d_torch (reader -> UNetSCN3D -> PointSegBatchlossHead)
against the JAX package's, from the same random Flax variables and the
same labelled numpy batch (B=2, V=N=1024, CPU), on
configs/tests/mini_semkitti_segnet.py (TransVFE) and on its lidar-baseline
variant (ImprovedMeanVFE feeding the backbone, as the MSeg3D papers'
lidar-only configs):

- the evaluation forward (voxel and point logits) within 1e-4 of the
  largest reference entry, ``predict``'s softmax within 1e-4 and its
  labels equal on at least 99.9% of the valid points (near-ties);
- one train step through ``apis.train.make_train_step`` against the JAX
  package's: the four loss terms, their sum and the gradient norm within
  1e-4 relative; every gradient within 1e-4 of its largest reference
  entry and 1e-4 in relative L2 norm, with an absolute floor of 1e-8 of
  the gradient norm for the tensors whose gradient is analytically zero
  (a bias in front of a BN, the attention's key bias); the JAX reference
  gradient is read from the first Adam moment (mu = (1 - b1) g, the clip
  inactive);
  the updated parameters within 1e-2 * lr where |g| >= 1e-5 and 2 * lr
  everywhere (Adam's first update is lr * sign(g) where |g| >> 1e-8); the
  BN running statistics within 1e-4 of their largest entry."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidarseg3d_tpu.apis import train as jtrain
from lidarseg3d_tpu.models import build_detector as jbuild
from lidarseg3d_tpu.solver.optim import build_one_cycle_optimizer as jbuild_opt
from lidarseg3d_torch import synthetic as syn
from lidarseg3d_torch.apis import train as ttrain
from lidarseg3d_torch.convert import (flax_params_to_named, flax_to_state_dict,
                                      load_flax_variables)
from lidarseg3d_torch.models import build_detector as tbuild
from lidarseg3d_torch.solver.optim import build_one_cycle_optimizer as tbuild_opt
from lidarseg3d_torch.utils.config import Config

from _torch_port_helpers import assert_close_rel, init_shapes, n, random_variables
from test_torch_port_support import MINI_CONFIG
from test_torch_port_support import one_torch_thread  # noqa: F401

MINI_SEGNET = MINI_CONFIG.replace("mini_semkitti_mseg3d", "mini_semkitti_segnet")
B, V, N = 2, 1024, 1024
OPT = dict(type="adam", wd=0.01)
LR = dict(lr_max=1e-3, moms=(0.95, 0.85), div_factor=10.0, pct_start=0.4)
TOTAL, CLIP = 10, 35.0
REL_FWD, REL_LOSS, REL_GRAD, REL_GRAD_L2, REL_STATS = 1e-4, 1e-4, 1e-4, 1e-4, 1e-4
MIN_AGREE = 0.999


def model_cfg(reader):
    cfg = Config.fromfile(MINI_SEGNET)
    m = copy.deepcopy(cfg.model.to_dict())
    if reader == "improved_mean":
        m["reader"] = dict(type="ImprovedMeanVoxelFeatureExtractor",
                           num_input_features=4)
        m["backbone"]["num_input_features"] = 12
    return m, cfg.point_cloud_range, cfg.voxel_size


@pytest.fixture(scope="module", params=["transvfe", "improved_mean"])
def run(request):
    cfg, pcr, vsz = model_cfg(request.param)
    batch = syn.synthetic_batch(B, V, N, seed=3, with_labels=True, pcr=pcr,
                                vsz=vsz)
    ishape = syn.grid_shape(pcr, vsz)
    jm = jbuild(copy.deepcopy(cfg))
    jex = {k: jnp.asarray(batch[k]) for k in jtrain.DEVICE_BATCH_KEYS
           if k in batch}
    variables = random_variables(
        init_shapes(jm, dict(jex, input_shape=ishape), train=False), seed=6)
    jstate0 = jtrain.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"], opt_state=())
    # the forward and the eval step in one compiled program (an eager
    # apply dispatches the sparse stack op by op)
    jret, jpred = jax.jit(lambda v, st, e: (
        jm.apply(v, dict(e, input_shape=ishape), train=False)[0],
        jtrain.make_eval_step(jm, ishape)(st, e)))(variables, jstate0, jex)
    tx, jlr = jbuild_opt(OPT, LR, TOTAL, grad_clip=CLIP)
    state = jtrain.TrainState(
        step=jstate0.step, params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]))
    new_state, jl = jax.jit(jtrain.make_train_step(jm, tx, ishape))(state,
                                                                    jex)

    tm = tbuild(copy.deepcopy(cfg), device="cpu")
    load_flax_variables(tm, jax.tree_util.tree_map(np.asarray, variables))
    ex = ttrain.example_to_device(batch, "cpu")
    ex["input_shape"] = ishape
    tret, tbat = tm(ex)
    tpred = tm.predict(tret, tbat)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    opt, tlr = tbuild_opt(OPT, LR, TOTAL, grad_clip=CLIP)
    tstate = ttrain.create_train_state(tm, opt)
    step = ttrain.make_train_step(tm, opt, ishape)
    tstate, tl = step(tstate, ttrain.example_to_device(batch, "cpu"))

    jl = {k: float(v) for k, v in jl.items()}
    assert jl["grad_norm"] < CLIP
    b1 = float(new_state.opt_state.hyperparams["b1"])
    mu = new_state.opt_state.inner_state[1].mu
    jgrads = flax_params_to_named(
        tm, jax.tree_util.tree_map(lambda m: np.asarray(m) / (1.0 - b1), mu))
    return dict(reader=request.param, batch=batch, jret=jret, jpred=jpred,
                tret=tret, tpred=tpred, jl=jl,
                tl={k: float(v) for k, v in tl.items()}, jgrads=jgrads,
                tm=tm, before=before, tstate=tstate, new_state=new_state,
                lr0=tlr(0), jlr0=float(jlr(0)))


def test_forward_and_predict_match(run):
    for k in ("conv_logits", "out_logits"):
        assert run["tret"][k].shape == np.asarray(run["jret"][k]).shape
        assert_close_rel(run["tret"][k], run["jret"][k], REL_FWD, k)
    valid = run["batch"]["point_valid"]
    assert_close_rel(n(run["tpred"]["point_softmax"])[valid],
                     np.asarray(run["jpred"]["point_softmax"])[valid],
                     REL_FWD, "point_softmax")
    got = n(run["tpred"]["pred_point_sem_labels"])[valid]
    want = np.asarray(run["jpred"]["pred_point_sem_labels"])[valid]
    assert (got == want).mean() >= MIN_AGREE


def test_loss_terms_and_grad_norm_match(run):
    assert set(run["tl"]) == set(run["jl"]) == {
        "loss", "grad_norm", "conv_ce_loss", "conv_lovasz_loss",
        "out_ce_loss", "out_lovasz_loss"}
    for k, want in run["jl"].items():
        assert np.isfinite(run["tl"][k]), k
        assert abs(run["tl"][k] - want) <= REL_LOSS * abs(want), (
            k, run["tl"][k], want)


def test_every_gradient_matches(run):
    named = dict(run["tm"].named_parameters())
    assert set(named) == set(run["jgrads"])
    if run["reader"] == "transvfe":
        assert any("EncoderLayers.0" in k for k in named)
    atol = 1e-8 * run["jl"]["grad_norm"]
    for k, want in run["jgrads"].items():
        got = named[k].grad
        assert got is not None and torch.isfinite(got).all(), k
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        assert err <= REL_GRAD * scale + atol, (k, err, scale)
        if scale > 10 * atol:
            l2 = float((got - want).norm() / want.norm())
            assert l2 <= REL_GRAD_L2, (k, l2)


def test_updated_parameters_and_bn_statistics_match(run):
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
    want = flax_to_state_dict(run["tm"], {
        "params": jax.tree_util.tree_map(np.asarray,
                                         run["new_state"].params),
        "batch_stats": jax.tree_util.tree_map(
            np.asarray, run["new_state"].batch_stats)})
    sd = run["tm"].state_dict()
    stats = [k for k in sd if k.endswith(("running_mean", "running_var"))]
    assert len(stats) > 40
    for k in stats:
        assert_close_rel(sd[k], want[k], REL_STATS, k)
    assert run["tstate"].step == 1 and int(run["new_state"].step) == 1
