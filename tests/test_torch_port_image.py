"""lidarseg3d_torch camera branch against the JAX package: HRNet-w18 with
one module / one block per stage (small_hrnet, the w18 widths) and the
FCN MSeg3D head at a 64x128 image, two cameras per frame, Flax weights
carried over by lidarseg3d_torch.convert; and the bilinear resize.

Tolerance: fp32, max |err| <= 1e-4 * max |reference| (convolutions in
another summation order; the JAX package runs its C<=18 branches in a
space-to-depth layout that computes the same sums differently)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from __graft_entry__ import _mseg3d_model_cfg
from lidarseg3d_tpu.models import build_img_backbone, build_img_head
from lidarseg3d_tpu.ops.resize import resize_bilinear as jresize
from lidarseg3d_torch.convert import load_flax_variables
from lidarseg3d_torch.models import build_img_backbone as tbuild_backbone
from lidarseg3d_torch.models import build_img_head as tbuild_head
from lidarseg3d_torch.ops.resize import resize_bilinear as tresize

from _torch_port_helpers import (assert_close_rel, init_shapes, n,
                                 random_variables, t)

REL = 1e-4


@pytest.fixture(scope="module")
def run():
    cfg = _mseg3d_model_cfg(ratio=1, small_hrnet=True)
    B, ncam, H, W = 1, 2, 64, 128
    imgs = np.random.default_rng(0).uniform(
        -2, 2, (B * ncam, H, W, 3)).astype(np.float32)
    jbb = build_img_backbone(dict(cfg["img_backbone"]))
    jhead = build_img_head(dict(cfg["img_head"]))
    vb = random_variables(init_shapes(jbb, jnp.asarray(imgs), train=False),
                          seed=1)
    feats_shape = jax.eval_shape(
        lambda: jbb.apply(vb, jnp.asarray(imgs), train=False))
    vh = random_variables(init_shapes(
        jhead, [jnp.zeros(s.shape) for s in feats_shape], batch_size=B,
        train=False), seed=2)

    @jax.jit
    def apply(vb, vh, x):
        feats = jbb.apply(vb, x, train=False)
        return feats, jhead.apply(vh, feats, batch_size=B, train=False)

    want_feats, want_head = apply(vb, vh, jnp.asarray(imgs))
    tbb = tbuild_backbone(dict(cfg["img_backbone"]))
    thead = tbuild_head(dict(cfg["img_head"]))
    load_flax_variables(tbb, vb)
    load_flax_variables(thead, vh)
    tbb.eval()
    thead.eval()
    with torch.inference_mode():
        feats = tbb(t(imgs).permute(0, 3, 1, 2))
        head = thead(feats, batch_size=B)
    return want_feats, want_head, feats, head


def test_hrnet_matches_jax(run):
    want_feats, _, feats, _ = run
    assert len(feats) == 4
    for i, (w, g) in enumerate(zip(want_feats, feats)):
        assert_close_rel(g.permute(0, 2, 3, 1), w, REL, f"branch {i}")


def test_fcn_head_matches_jax(run):
    _, want, _, got = run
    for k in ("image_features", "image_logits",
              "camera_semantic_embeddings"):
        assert_close_rel(got[k], want[k], REL, k)
    assert tuple(got["image_features"].shape) == (2, 16, 32, 48)


@pytest.mark.parametrize("hw,out", [((4, 5), (8, 10)), ((3, 4), (24, 32)),
                                    ((5, 7), (12, 20)), ((6, 6), (6, 6))])
def test_resize_matches_jax(hw, out):
    x = np.random.default_rng(1).normal(size=(2, *hw, 3)).astype(np.float32)
    want = jresize(jnp.asarray(x), out)
    got = tresize(t(x).permute(0, 3, 1, 2), out).permute(0, 2, 3, 1)
    np.testing.assert_allclose(n(got), n(want), rtol=1e-5, atol=1e-6)


def test_resize_refuses_downscale():
    with pytest.raises(NotImplementedError):
        tresize(torch.zeros(1, 1, 8, 8), (4, 8))
