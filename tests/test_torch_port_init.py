"""The port's seeded initialization (``models/layers.py``
``init_parameters``) against the initializers the JAX package's modules
draw from, kind by kind: Flax's ``nn.Conv``, ``nn.ConvTranspose`` and
``MultiHeadDotProductAttention`` (``lecun_normal`` kernels, zero biases),
the package's ``TorchLinear`` and sparse-conv kernels (torch's uniform) and
the DCN kernel (``variance_scaling(1, "fan_in", "uniform")``). The two
packages draw from different generators, so the distributions are
compared: each kind's standard deviation within 3% and its largest
magnitude within 3% of JAX's on the same shape (16k draws or more a kind: a
standard deviation off by the old init's 1.73x, or a bound off by the
DCN's old 0.577x, fails by far), biases equal (zero or drawn)."""

import numpy as np
import pytest
import torch
from torch import nn

from lidarseg3d_torch.models.bbox_heads.center_head import FeatureAdaption
from lidarseg3d_torch.models.layers import TorchLinear, init_parameters
from lidarseg3d_torch.models.point_heads.mseg3d_head import (
    MultiHeadDotProductAttention)
from lidarseg3d_torch.models.sparse_modules import SubMConv3d

REL = 0.03


def _port(module):
    init_parameters(module, torch.Generator().manual_seed(0))
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def _jax_params(module, *inputs):
    import jax

    return jax.tree_util.tree_map(
        np.asarray, module.init(jax.random.PRNGKey(0), *inputs)["params"])


def _same_distribution(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.size == want.size, what
    for stat in (np.std, lambda a: np.abs(a).max()):
        g, w = stat(got), stat(want)
        assert abs(g - w) <= REL * w, (what, g, w)


def _case_conv():
    import flax.linen as fnn
    import jax.numpy as jnp

    p = _port(nn.Conv2d(64, 64, 3, padding=1))
    j = _jax_params(fnn.Conv(64, (3, 3)), jnp.zeros((1, 4, 4, 64)))
    return [("weight", p["weight"], j["kernel"]), ("bias", p["bias"],
                                                     j["bias"])]


def _case_conv_transpose():
    import flax.linen as fnn
    import jax.numpy as jnp

    p = _port(nn.ConvTranspose2d(128, 32, 2, stride=2))
    j = _jax_params(fnn.ConvTranspose(32, (2, 2), strides=(2, 2)),
                    jnp.zeros((1, 4, 4, 128)))
    return [("weight", p["weight"], j["kernel"]), ("bias", p["bias"],
                                                     j["bias"])]


def _case_attention():
    import flax.linen as fnn
    import jax.numpy as jnp

    p = _port(MultiHeadDotProductAttention(128, 8))
    x = jnp.zeros((1, 3, 128))
    j = _jax_params(fnn.MultiHeadDotProductAttention(
        num_heads=8, qkv_features=128), x, x)
    return [(f"{n}.{k}", p[f"{n}.{k}"], j[n][jk])
            for n in ("query", "key", "value", "out")
            for k, jk in (("weight", "kernel"), ("bias", "bias"))]


def _case_torch_linear():
    import jax.numpy as jnp
    from lidarseg3d_tpu.models.layers import TorchLinear as JaxLinear

    p = _port(TorchLinear(128, 4096))
    j = _jax_params(JaxLinear(4096), jnp.zeros((1, 128)))
    return [("weight", p["weight"], j["kernel"]), ("bias", p["bias"],
                                                     j["bias"])]


def _case_sparse_conv():
    import jax
    from lidarseg3d_tpu.models.layers import conv_kernel_init

    p = _port(SubMConv3d(32, 64, 3))
    return [("weight", p["weight"],
             conv_kernel_init(jax.random.PRNGKey(0), (27, 32, 64)))]


def _case_dcn():
    import flax.linen as fnn
    import jax

    p = _port(FeatureAdaption(64, 64))
    want = fnn.initializers.variance_scaling(1.0, "fan_in", "uniform")(
        jax.random.PRNGKey(0), (9, 64, 64))
    return [("deform_kernel", p["deform_kernel"], want),
            ("offset conv", p["Conv_0.weight"], np.zeros(
                p["Conv_0.weight"].shape))]


CASES = {"conv": _case_conv, "conv_transpose": _case_conv_transpose,
         "attention": _case_attention, "torch_linear": _case_torch_linear,
         "sparse_conv": _case_sparse_conv, "dcn": _case_dcn}


@pytest.mark.parametrize("kind", sorted(CASES))
def test_init_matches_jax_initializers(kind):
    for name, got, want in CASES[kind]():
        if not np.any(want):  # a constant initializer: equal
            np.testing.assert_array_equal(got, np.zeros_like(got),
                                          err_msg=f"{kind} {name}")
        else:
            _same_distribution(got, want, f"{kind} {name}")
