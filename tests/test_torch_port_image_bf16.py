"""lidarseg3d_torch's bf16 camera branch (compute_dtype="bfloat16": bf16
activations, fp32 parameters cast at each conv, BN in fp32, fp32 outputs)
against the JAX package's fp32 branch with the same Flax weights:
HRNet-w18 with one module / one block per stage (small_hrnet) and the FCN
MSeg3D head, six cameras at 64x96.

The JAX side runs in fp32 only: compiling its bf16 convs on the XLA CPU
backend inside a long pytest process segfaults (tests/_bf16_test_body.py).

Tolerance, per output, max |err| / max |fp32 reference|: about twice what
this test measured on the CPU (1.75% features, 1.47% logits, 0.63%
embeddings), well inside the JAX package's own bf16 bound of 0.1
(tests/_bf16_test_body.py). A BN computed in bf16 moves these by less than
that margin, so the BN semantics are pinned by their own test: on a bf16
input, MaskedBatchNorm equals the fp32 computation rounded once, exactly,
and the JAX package's BN within one bf16 rounding."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from __graft_entry__ import _mseg3d_model_cfg
from lidarseg3d_tpu.models import build_img_backbone, build_img_head
from lidarseg3d_tpu.models.layers import MaskedBatchNorm as JBatchNorm
from lidarseg3d_torch import synthetic as syn
from lidarseg3d_torch.convert import load_flax_variables
from lidarseg3d_torch.models import build_img_backbone as tbuild_backbone
from lidarseg3d_torch.models import build_img_head as tbuild_head
from lidarseg3d_torch.models.layers import MaskedBatchNorm

from _torch_port_helpers import (assert_close_rel, init_shapes,
                                 random_variables, t)

REL = {"image_features": 0.035, "image_logits": 0.03,
       "camera_semantic_embeddings": 0.013}
KEYS = ("image_features", "image_logits", "camera_semantic_embeddings")


@pytest.fixture(scope="module")
def run():
    B, ncam, H, W = 1, 6, 64, 96
    imgs = np.random.default_rng(0).uniform(
        -2, 2, (B * ncam, H, W, 3)).astype(np.float32)
    jcfg = _mseg3d_model_cfg(ratio=1, small_hrnet=True)
    jbb = build_img_backbone(dict(jcfg["img_backbone"]))
    jhead = build_img_head(dict(jcfg["img_head"]))
    vb = random_variables(init_shapes(jbb, jnp.asarray(imgs), train=False),
                          seed=1)
    feats_shape = jax.eval_shape(
        lambda: jbb.apply(vb, jnp.asarray(imgs), train=False))
    vh = random_variables(init_shapes(
        jhead, [jnp.zeros(s.shape) for s in feats_shape], batch_size=B,
        train=False), seed=2)

    @jax.jit
    def apply(vb, vh, x):
        return jhead.apply(vh, jbb.apply(vb, x, train=False), batch_size=B,
                           train=False)

    want = apply(vb, vh, jnp.asarray(imgs))
    tcfg = syn.mseg3d_model_cfg(ratio=1, small_hrnet=True, img_bf16=True)
    assert tcfg["img_backbone"]["compute_dtype"] == "bfloat16"
    assert tcfg["img_head"]["compute_dtype"] == "bfloat16"
    tbb = tbuild_backbone(dict(tcfg["img_backbone"]))
    thead = tbuild_head(dict(tcfg["img_head"]))
    load_flax_variables(tbb, vb)
    load_flax_variables(thead, vh)
    tbb.eval()
    thead.eval()
    with torch.inference_mode():
        feats = tbb(t(imgs).permute(0, 3, 1, 2))
        got = thead(feats, batch_size=B)
    return dict(want=want, got=got, feats=feats, tbb=tbb, thead=thead)


@pytest.mark.parametrize("key", KEYS)
def test_bf16_branch_matches_jax_fp32(run, key):
    got = run["got"][key]
    assert got.dtype == torch.float32
    assert_close_rel(got, run["want"][key], REL[key], key)


def test_bf16_branch_keeps_fp32_parameters(run):
    assert all(f.dtype == torch.bfloat16 for f in run["feats"])
    for m in (run["tbb"], run["thead"]):
        for name, p in m.state_dict().items():
            assert p.dtype == torch.float32, name
    assert tuple(run["got"]["image_features"].shape) == (6, 16, 24, 48)


def test_bf16_batchnorm_computes_in_fp32():
    """BN on a bf16 input: normalize in fp32 with fp32 statistics and
    parameters, round once to bf16. A BN done in bf16 throughout differs."""
    rng = np.random.default_rng(5)
    C, eps = 24, 1e-5
    x = rng.normal(3.0, 4.0, (2, 9, 11, C)).astype(np.float32)
    mean = rng.normal(3.0, 1.0, C).astype(np.float32)
    var = rng.uniform(0.5, 20.0, C).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, C).astype(np.float32)
    bias = rng.normal(0.0, 1.0, C).astype(np.float32)
    bn = MaskedBatchNorm(C, eps=eps, channel_dim=-1).eval()
    with torch.no_grad():
        bn.running_mean.copy_(t(mean))
        bn.running_var.copy_(t(var))
        bn.weight.copy_(t(scale))
        bn.bias.copy_(t(bias))
    xb = t(x).to(torch.bfloat16)
    got = bn(xb)
    assert got.dtype == torch.bfloat16
    x32 = xb.float()
    want = ((x32 - t(mean)) * torch.rsqrt(t(var) + eps) * t(scale)
            + t(bias)).to(torch.bfloat16)
    assert torch.equal(got, want)
    bf = lambda a: t(a).to(torch.bfloat16)  # noqa: E731
    in_bf16 = ((xb - bf(mean)) * torch.rsqrt(bf(var) + eps) * bf(scale)
               + bf(bias))
    assert not torch.equal(in_bf16, want)

    jvars = {"params": {"scale": jnp.asarray(scale),
                        "bias": jnp.asarray(bias)},
             "batch_stats": {"mean": jnp.asarray(mean),
                             "var": jnp.asarray(var)}}
    jy = JBatchNorm(eps=eps).apply(jvars, jnp.asarray(x, jnp.bfloat16),
                                   train=False)
    assert jy.dtype == jnp.bfloat16
    jy = np.asarray(jy.astype(jnp.float32))
    g = got.detach().float().numpy()
    # one bf16 rounding of the same fp32 value: within 2^-8 relative
    assert np.all(np.abs(g - jy) <= 2.0 ** -8 * np.abs(jy) + 1e-30)
