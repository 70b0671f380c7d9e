"""The image-side modules the MSeg3D configs do not use, against the JAX
package with Flax weights carried across by lidarseg3d_torch.convert:

- HRNet-w48 (the w48 ``extra``: 48/96/192/384 channels, 1/1/4/3 modules
  of 4 blocks) at one 64x64 image: the forward in evaluation, and a
  training step of the backbone alone (batch statistics, the gradients of
  a fixed linear loss of the four outputs, the updated running
  statistics);
- FCNMSeg3DHead with ``use_sc_conv`` (an SCBottleneck after the first
  conv: models/img_heads/sc_conv.py) on a seeded pyramid, its outputs and
  its gradients in training;
- FCNHead (resize-concat, concat_input), its outputs and pixel CE;
- ResNetMMCV at depths 50 and 18 (the deep stem, 64x64), the forward of
  the four stages and the parameter gradients in training; at depth 50
  the input's gradient too, at depth 18 the frozen-stage semantics
  (frozen_stages=1: the stem and stage 1 get no gradient).

Tolerances: the evaluation forwards in fp32 within 1e-4 of the outputs'
max (another order of summation than XLA); the training steps in float64
on both sides (JAX under ``jax.enable_x64``) within 1e-6 of each tensor's
max (outputs, gradients, BN statistics; the losses sum_i <out_i, w_i>
within 1e-6 of sum |o w|): in fp32 both frameworks are 1-7% of a
gradient's max off a float64 run here (batch statistics over as few as 4
pixels a channel at the deepest stages, random weights), so fp32 could
not tell a fault from noise. The heads cast their outputs to fp32 in the
JAX package, so their float64 gradients carry fp32 roundings (~1e-7);
the pixel CE within 1e-5 relative."""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lidarseg3d_tpu.models import build_img_backbone as jbackbone
from lidarseg3d_tpu.models import build_img_head as jhead
from lidarseg3d_torch.convert import (flax_params_to_named,
                                      flax_to_state_dict,
                                      load_flax_variables)
from lidarseg3d_torch.models import build_img_backbone as tbackbone
from lidarseg3d_torch.models import build_img_head as thead
from lidarseg3d_torch.tools.convert_hrnet_checkpoint import HRNET_EXTRA

from _torch_port_helpers import (assert_close_rel, init_shapes,
                                 random_variables, t)
from test_torch_port_support import one_torch_thread  # noqa: F401

REL_OUT, REL_F64 = 1e-4, 1e-6
W48 = dict(
    stage1=dict(num_modules=1, num_branches=1, block="BOTTLENECK",
                num_blocks=(4,), num_channels=(64,)),
    stage2=dict(num_modules=1, num_branches=2, block="BASIC",
                num_blocks=(4, 4), num_channels=(48, 96)),
    stage3=dict(num_modules=4, num_branches=3, block="BASIC",
                num_blocks=(4, 4, 4), num_channels=(48, 96, 192)),
    stage4=dict(num_modules=3, num_branches=4, block="BASIC",
                num_blocks=(4, 4, 4, 4), num_channels=(48, 96, 192, 384)))


def nchw(x):
    return t(np.asarray(x)).permute(0, 3, 1, 2)


def f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                  tree)


def jax_train(module, variables, inputs, weights, **kw):
    """A training forward of ``module`` in float64 with batch statistics
    and the gradient of sum_i <out_i, weights_i>: ((loss, sum |o w|),
    outputs, grads, new stats)."""
    with jax.enable_x64(True):
        return _jax_train(module, f64(variables), f64(inputs), f64(weights),
                          **kw)


def _jax_train(module, variables, inputs, weights, **kw):
    def loss(params):
        outs, upd = module.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            inputs, train=True, mutable=["batch_stats"], **kw)
        if isinstance(outs, dict):
            outs = [outs[k] for k in sorted(outs)]
        return sum(jnp.sum(o * w) for o, w in zip(outs, weights)), (outs,
                                                                   upd)
    

    (val, (outs, upd)), g = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(variables["params"])
    np_ = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa
    # the loss's scale: sum |o * w| (its terms cancel)
    scale = sum(float(jnp.sum(jnp.abs(o * w))) for o, w in zip(outs,
                                                               weights))
    return (float(val), scale), outs, np_(g), np_(upd["batch_stats"])


def check_train(tm, variables, loss, got_outs, jres, perm):
    """Port vs JAX after one training forward and backward, in float64."""
    (jval, scale), jouts, jgrads, jstats = jres
    assert abs(float(loss) - jval) <= REL_F64 * scale
    for i, (g, w) in enumerate(zip(got_outs, jouts)):
        assert_close_rel(perm(g), w, REL_F64, f"output {i}")
    want = flax_params_to_named(tm, jgrads)
    named = dict(tm.named_parameters())
    for k, w in want.items():
        g = named[k].grad  # None where no gradient reaches (frozen)
        assert_close_rel(torch.zeros_like(w) if g is None else g, w,
                         REL_F64, f"grad {k}")
    stats = flax_to_state_dict(tm, {"params": variables["params"],
                                    "batch_stats": jstats})
    sd = tm.state_dict()
    for k, w in stats.items():
        if "running" in k:
            assert_close_rel(sd[k], w, REL_F64, k)


@pytest.fixture(scope="module")
def w48():
    cfg = dict(type="HRNet", extra=W48)
    x = np.random.default_rng(0).uniform(-2, 2, (1, 64, 64, 3)).astype(
        np.float32)
    jm = jbackbone(dict(cfg))
    variables = random_variables(init_shapes(jm, jnp.asarray(x),
                                             train=False), seed=1)
    tm = tbackbone(dict(cfg))
    load_flax_variables(tm, variables)
    return dict(jm=jm, variables=variables, tm=tm, x=x)


def test_w48_extra_is_the_converters(w48):
    for k, v in W48.items():
        for f in ("num_modules", "num_blocks", "num_channels"):
            assert tuple(np.atleast_1d(HRNET_EXTRA[48][k][f])) == tuple(
                np.atleast_1d(v[f])), (k, f)
    trans, stack = w48["tm"].stages[-1]
    assert len(stack.scan) == 3
    assert [blocks[0].body[0].Conv_0.out_channels
            for blocks in stack.scan[0].branches] == [48, 96, 192, 384]


def test_w48_forward_matches_jax(w48):
    want = jax.jit(lambda v, x: w48["jm"].apply(v, x, train=False))(
        w48["variables"], jnp.asarray(w48["x"]))
    tm = w48["tm"].eval()
    with torch.inference_mode():
        got = tm(nchw(w48["x"]))
    assert [tuple(g.shape[1:2]) for g in got] == [(48,), (96,), (192,),
                                                  (384,)]
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close_rel(g.permute(0, 2, 3, 1), w, REL_OUT, f"branch {i}")


def test_w48_train_step_matches_jax(w48):
    rng = np.random.default_rng(2)
    shapes = [(1, 16 >> i, 16 >> i, c)
              for i, c in enumerate((48, 96, 192, 384))]
    weights = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
    jres = jax_train(w48["jm"], w48["variables"], jnp.asarray(w48["x"]),
                     [jnp.asarray(w) for w in weights])
    tm = copy.deepcopy(w48["tm"]).double().train()
    outs = tm(nchw(w48["x"]).double())
    loss = sum((o.permute(0, 2, 3, 1) * t(w).double()).sum()
               for o, w in zip(outs, weights))
    loss.backward()
    check_train(tm, w48["variables"], loss.detach(), outs, jres,
                lambda g: g.detach().permute(0, 2, 3, 1))


def pyramid(seed, chans=(8, 12, 16, 20), hw=(16, 24), n=2):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, (n, hw[0] >> i, hw[1] >> i, c)).astype(
        np.float32) for i, c in enumerate(chans)]


HEADS = {
    "sc_conv": dict(type="FCNMSeg3DHead", in_channels=(8, 12, 16, 20),
                    channels=16, num_convs=3, num_classes=7,
                    use_sc_conv=True, concat_input=True),
    "fcn": dict(type="FCNHead", in_channels=(8, 12, 16, 20), channels=16,
                num_convs=2, kernel_size=3, concat_input=True,
                num_classes=7),
}


@pytest.mark.parametrize("name", sorted(HEADS))
def test_head_matches_jax(name):
    cfg = HEADS[name]
    feats = pyramid(3)
    jm = jhead(dict(cfg))
    jin = [jnp.asarray(f) for f in feats]
    variables = random_variables(init_shapes(jm, jin, batch_size=1,
                                             train=False), seed=4)
    tm = thead(dict(cfg))
    load_flax_variables(tm, variables)
    if name == "sc_conv":
        assert "SCBottleneck_0.SCConv_0.Conv_2.weight" in tm.state_dict()
    want = jax.jit(lambda v, x: jm.apply(v, x, batch_size=1, train=False))(
        variables, jin)
    with torch.inference_mode():
        got = tm.eval()([nchw(f) for f in feats], batch_size=1)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32
        assert_close_rel(got[k], want[k], REL_OUT, k)

    # training: batch statistics, gradients of a fixed loss of the outputs
    rng = np.random.default_rng(5)
    weights = [rng.normal(0, 1, np.shape(want[k])).astype(np.float32)
               for k in sorted(want)]
    jres = jax_train(jm, variables, jin, [jnp.asarray(w) for w in weights],
                     batch_size=1)
    tm = tm.double().train()
    out = tm([nchw(f).double() for f in feats], batch_size=1)
    outs = [out[k] for k in sorted(out)]
    loss = sum((o * t(w).double()).sum() for o, w in zip(outs, weights))
    loss.backward()
    check_train(tm, variables, loss.detach(), outs, jres,
                lambda g: g.detach())

    if name == "fcn":  # the pixel CE at the image resolution
        labels = np.random.default_rng(6).integers(0, 7, (2, 32, 48))
        ret = {k: jnp.asarray(np.asarray(v)) for k, v in want.items()}
        jl, _ = jm.get_loss(ret, {"images_sem_labels": jnp.asarray(labels)})
        tl, ld = tm.get_loss({k: t(np.asarray(v)) for k, v in want.items()},
                             {"images_sem_labels": t(labels)})
        assert set(ld) == {"image_ce_loss"}
        assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))


@pytest.mark.parametrize("depth,frozen", [(50, -1), (18, 1)])
def test_resnet_matches_jax(depth, frozen):
    cfg = dict(type="ResNetMMCV", depth=depth, frozen_stages=frozen)
    x = np.random.default_rng(7).uniform(-2, 2, (2, 64, 64, 3)).astype(
        np.float32)
    jm = jbackbone(dict(cfg))
    variables = random_variables(init_shapes(jm, jnp.asarray(x),
                                             train=False), seed=8)
    tm = tbackbone(dict(cfg))
    load_flax_variables(tm, variables)
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        variables, jnp.asarray(x))
    with torch.inference_mode():
        got = tm.eval()(nchw(x))
    assert len(got) == 4
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close_rel(g.permute(0, 2, 3, 1), w, REL_OUT, f"stage {i}")

    rng = np.random.default_rng(9)
    weights = [rng.normal(0, 1, np.shape(w)).astype(np.float32)
               for w in want]
    jres = jax_train(jm, variables, jnp.asarray(x),
                     [jnp.asarray(w) for w in weights])
    tm = tm.double().train()
    xin = nchw(x).double().requires_grad_(True)
    outs = tm(xin)
    loss = sum((o.permute(0, 2, 3, 1) * t(w).double()).sum()
               for o, w in zip(outs, weights))
    loss.backward()
    check_train(tm, variables, loss.detach(), outs, jres,
                lambda g: g.detach().permute(0, 2, 3, 1))
    frozen_names = set(tm.frozen_parameters())
    if frozen >= 1:
        assert any(k.startswith("ConvBNReLU_0.") for k in frozen_names)
        for k, p in tm.named_parameters():
            assert (k in frozen_names) == (p.grad is None
                                           or not p.grad.any()), k
    else:
        assert frozen_names == set() and xin.grad.abs().sum() > 0
