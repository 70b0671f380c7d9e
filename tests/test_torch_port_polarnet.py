"""PolarNet (SegPolarNet: the dynamic BEV VFE, the circular-padded BEV
UNet and the PolarNet head) of lidarseg3d_torch against the JAX package's,
at a small size (grid 32x32x8, a 64-wide PP model, B=2, N=400), on the
CPU: forward and predict, one train step with DropBlock at rate 0 (every
loss term, gradient, updated parameter and BN statistic; tolerances in
tests/_segpolar_parity.py), the reader's BEV features within 1e-5; and
DropBlock's mask on its own: its keep rate against the JAX package's
(both draw their own random numbers) and its scaling."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidarseg3d_tpu.models.backbones.polarnet_unet import DropBlock2D as JDrop
from lidarseg3d_tpu.models.readers import dynamic_vfe as jvfe
from lidarseg3d_torch.convert import load_flax_variables
from lidarseg3d_torch.models.backbones import polarnet_unet as tunet
from lidarseg3d_torch.models.readers import dynamic_vfe as tvfe

import _segpolar_parity as P
from _torch_port_helpers import assert_close_rel, init_shapes, n, random_variables, t
from test_torch_port_support import one_torch_thread  # noqa: F401

GRID = (32, 32, 8)
NCLS = 6
READER = dict(type="PolarNetDynamicVoxelFeatureExtractor", grid_size=GRID,
              point_cloud_range=P.CYLR, average_points=False,
              num_input_features=5, num_output_features=64,
              fea_compre=GRID[-1])


def cfg(dropout):
    return dict(
        type="SegPolarNet", reader=dict(READER),
        backbone=dict(type="PolarNet_BEV_Unet", n_class=NCLS,
                      n_height=GRID[-1], input_batch_norm=True,
                      dropout=dropout, circular_padding=True),
        point_head=dict(type="PointSegPolarNetHead", class_agnostic=False,
                        num_class=NCLS, model_cfg=dict(IGNORED_LABEL=0)))


@pytest.fixture(scope="module")
def run():
    return P.run(cfg(0.0), P.make_batch(2, 400, NCLS, seed=2),
                 ("out_logits",), jax_step="grad")


def test_forward_and_predict_match(run):
    P.check_forward(run)
    assert tuple(run["tbat"]["bev_logits"].shape) == (2,) + GRID + (NCLS,)


def test_loss_terms_and_grad_norm_match(run):
    P.check_losses(run, ("out_ce_loss", "out_lvsz_loss"))


def test_every_gradient_matches(run):
    """The reference gradient here is one jax.grad program of the JAX
    package's training loss (_segpolar_parity._grad_reference), with the
    optimizer's update applied to it for the updated parameters; the loss
    terms and BN statistics are its compiled make_train_step's. The BEV
    UNet's fp32 gradient differs between any two programs that round its
    forward differently: a 2x2 max-pool window whose top two entries lie a
    rounding apart (the first pool's windows hold gaps of 1e-8 to 2e-7 of
    the map's max on every seed tried) routes its gradient to whichever
    entry the program makes the largest. On this batch the JAX package's
    own make_train_step and jax.grad programs differ by up to 2.7e-2 of a
    tensor's max, and a float64 run of the port is 1.5e-2 off both fp32
    packages; the port agrees with the jax.grad program to 2.3e-5 (found
    while porting this model)."""
    P.check_gradients(run)


def test_updated_parameters_and_bn_statistics_match(run):
    P.check_update(run, min_stats=40)


@pytest.mark.parametrize("average", [False, True])
def test_reader_matches_jax(average):
    rd = dict(READER, average_points=average)
    del rd["type"]
    batch = P.make_batch(2, 400, NCLS, seed=3)
    jr = jvfe.PolarNetDynamicVoxelFeatureExtractor(**rd)
    args = (jnp.asarray(batch["points"]), jnp.asarray(batch["point_valid"]))
    v = random_variables(init_shapes(jr, *args, train=False), seed=4)
    want, _ = jax.jit(lambda v, *a: jr.apply(
        v, *a, train=True, mutable=["batch_stats"]))(v, *args)
    tr = tvfe.PolarNetDynamicVoxelFeatureExtractor(**rd)
    load_flax_variables(tr, jax.tree_util.tree_map(np.asarray, v))
    got = tr.train()(t(batch["points"]), t(batch["point_valid"]))
    np.testing.assert_array_equal(n(got["point_vcoors"]),
                                  n(want["point_vcoors"]))
    assert_close_rel(got["bev_features"], want["bev_features"], 1e-5,
                     "bev_features")


def test_dropblock_keep_rate_and_scaling():
    """Over 16 draws of a [4, 64, 64] map at rate 0.5 (block 7), the
    port's mean keep rate is within 0.02 of the JAX package's; each draw
    scales the kept entries by size / kept, so a map of ones keeps its
    sum; no draw in evaluation mode or at rate 0."""
    x = torch.ones(4, 3, 64, 64)
    drop = tunet.DropBlock2D(0.5).train()
    g = torch.Generator().manual_seed(0)
    rates = []
    for _ in range(16):
        y = drop(x, g)
        kept = (y[:, :1] != 0).to(torch.float32)
        rates.append(float(kept.mean()))
        assert torch.allclose(y[:, :1].sum(), x[:, :1].sum(), rtol=1e-5)
        assert torch.equal(y[:, 0], y[:, 2])  # one mask for every channel
    jd = JDrop(0.5)
    jx = jnp.ones((4, 64, 64, 3))
    jrates = [float((jd.apply({}, jx, True, rngs={"dropout":
                                                  jax.random.PRNGKey(i)})
                     [..., 0] != 0).mean()) for i in range(16)]
    assert 0.2 < np.mean(rates) < 0.8
    assert abs(np.mean(rates) - np.mean(jrates)) < 0.02, (rates, jrates)
    assert torch.equal(drop.eval()(x, g), x)
    assert torch.equal(tunet.DropBlock2D(0.0).train()(x, g), x)
