"""lidarseg3d_torch MaskedBatchNorm in training mode against the JAX
package's module: output, new running statistics and the input gradient,
for masked, unmasked, channel_dim=1 and bf16 inputs.

Tolerance: fp32, max |err| <= 1e-5 * max |reference| (sums over the batch
in another order); for the bf16 input the outputs are compared in fp32 and
may differ by one bf16 rounding, 2**-8 relative, while the statistics (fp32
on both sides) keep 1e-5."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lidarseg3d_tpu.models.layers import MaskedBatchNorm as JBN
from lidarseg3d_torch.models.layers import MaskedBatchNorm as TBN

from _torch_port_helpers import assert_close_rel, n, t

REL = 1e-5
REL_BF16 = 2.0 ** -8
C = 6


def _variables(rng):
    return {"params": {"scale": rng.uniform(0.5, 1.5, C).astype(np.float32),
                       "bias": rng.normal(0, 0.1, C).astype(np.float32)},
            "batch_stats": {
                "mean": rng.normal(0, 0.2, C).astype(np.float32),
                "var": rng.uniform(0.5, 2.0, C).astype(np.float32)}}


def _torch_bn(v, **kw):
    m = TBN(C, **kw)
    with torch.no_grad():
        m.weight.copy_(t(v["params"]["scale"]))
        m.bias.copy_(t(v["params"]["bias"]))
        m.running_mean.copy_(t(v["batch_stats"]["mean"]))
        m.running_var.copy_(t(v["batch_stats"]["var"]))
    return m.train()


def _jax_run(v, x, mask, g, momentum, eps):
    bn = JBN(momentum=momentum, eps=eps)
    jv = jax.tree_util.tree_map(jnp.asarray, v)
    jm = None if mask is None else jnp.asarray(mask)

    def f(xj):
        y, new = bn.apply(jv, xj, mask=jm, train=True,
                          mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * jnp.asarray(g)), (y, new)

    (_, (y, new)), gx = jax.value_and_grad(f, has_aux=True)(jnp.asarray(x))
    return y, new["batch_stats"], gx


@pytest.mark.parametrize("case", ["masked", "unmasked", "all_masked_out",
                                  "one_valid"])
def test_training_matches_jax(case):
    rng = np.random.default_rng(0)
    v = _variables(rng)
    x = rng.normal(1.0, 2.0, size=(2, 50, C)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    mask = {"masked": rng.random((2, 50)) < 0.6, "unmasked": None,
            "all_masked_out": np.zeros((2, 50), bool),
            "one_valid": np.arange(100).reshape(2, 50) == 7}[case]
    momentum, eps = 0.01, 1e-3
    y, stats, gx = _jax_run(v, x, mask, g, momentum, eps)

    m = _torch_bn(v, eps=eps, momentum=momentum)
    xt = t(x).requires_grad_(True)
    out = m(xt, mask=None if mask is None else t(mask))
    (out * t(g)).sum().backward()
    assert_close_rel(out, y, REL, "output")
    assert_close_rel(m.running_mean, stats["mean"], REL, "running mean")
    assert_close_rel(m.running_var, stats["var"], REL, "running var")
    assert_close_rel(xt.grad, gx, 10 * REL, "input gradient")
    assert not m.running_mean.requires_grad


def test_channel_dim_1_matches_jax_channels_last():
    """HRNet's BN: NCHW with channel_dim=1 in the port, NHWC in the JAX
    package, no mask."""
    rng = np.random.default_rng(1)
    v = _variables(rng)
    x = rng.normal(0.5, 1.5, size=(3, 5, 7, C)).astype(np.float32)  # NHWC
    g = rng.normal(size=x.shape).astype(np.float32)
    y, stats, gx = _jax_run(v, x, None, g, 0.1, 1e-5)
    m = _torch_bn(v, channel_dim=1)
    xt = t(x).permute(0, 3, 1, 2).contiguous().requires_grad_(True)
    out = m(xt)
    (out * t(g).permute(0, 3, 1, 2)).sum().backward()
    assert_close_rel(out.permute(0, 2, 3, 1), y, REL, "output")
    assert_close_rel(m.running_mean, stats["mean"], REL, "running mean")
    assert_close_rel(m.running_var, stats["var"], REL, "running var")
    assert_close_rel(xt.grad.permute(0, 2, 3, 1), gx, 10 * REL, "gradient")


def test_bf16_input_statistics_in_fp32():
    rng = np.random.default_rng(2)
    v = _variables(rng)
    x32 = rng.normal(1.0, 2.0, size=(2, 40, C)).astype(np.float32)
    xb = t(x32).to(torch.bfloat16)
    x = xb.float().numpy()  # the bf16 values, exactly, for both sides
    mask = rng.random((2, 40)) < 0.7
    g = rng.normal(size=x.shape).astype(np.float32)
    # the JAX module on the same values in fp32: its bf16 path computes
    # the same fp32 statistics and rounds the output once
    y, stats, _ = _jax_run(v, x, mask, g, 0.1, 1e-5)
    m = _torch_bn(v)
    out = m(xb, mask=t(mask))
    assert out.dtype == torch.bfloat16
    assert_close_rel(out.float(), y, REL_BF16, "output")
    assert_close_rel(m.running_mean, stats["mean"], REL, "running mean")
    assert_close_rel(m.running_var, stats["var"], REL, "running var")


def test_eval_mode_leaves_running_statistics():
    rng = np.random.default_rng(3)
    v = _variables(rng)
    m = _torch_bn(v).eval()
    x = t(rng.normal(size=(1, 9, C)).astype(np.float32))
    bn = JBN()
    want = bn.apply(jax.tree_util.tree_map(jnp.asarray, v), jnp.asarray(n(x)),
                    train=False)
    assert_close_rel(m(x), want, REL, "eval output")
    np.testing.assert_array_equal(n(m.running_mean), v["batch_stats"]["mean"])
