"""lidarseg3d_torch's voxel readers against the JAX package's: TransVFE
(SDSeg3D's TransformerVoxelFeatureExtractor) forward and gradients, its
attention against tiny_token_attention's custom VJP, the unstacking of the
scanned EncoderLayers by convert.py, the per-layer checkpoint on and off,
and MeanVoxelFeatureExtractor, on the same seeded numpy inputs (CPU).

Tolerances (fp32, another order of summation than XLA): forward within
1e-5 of the largest reference entry, gradients within 1e-4 of each
tensor's largest reference entry, except the key projection's bias,
whose gradient is analytically zero (the softmax is invariant to a shift
along the key axis): there both sides hold rounding noise, which must stay
below 1e-6 of the largest gradient entry of the reader. The gradient
with respect to the point features is compared where JAX's is finite:
JAX's is NaN wherever a slot's offset from its voxel's mean is the zero
vector (padded slots, one-point voxels), from the norm's derivative at 0;
the port's is finite (torch's norm takes the subgradient 0 there). No path
asks for that gradient: the features are data. The checkpoint on and off
give equal gradients bit for bit (the recompute runs the same ops on the same
inputs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidarseg3d_tpu.models.readers import voxel_encoders as jve
from lidarseg3d_torch.convert import flax_params_to_named, flax_to_state_dict
from lidarseg3d_torch.convert import load_flax_variables
from lidarseg3d_torch.models.readers import voxel_encoders as tve

from _torch_port_helpers import assert_close_rel, init_shapes, n, random_variables, t

B, V, P = 2, 48, 5
CFG = dict(num_input_features=4, num_compressed_features=16, num_embed=32,
           num_head=4, num_layers=2)
REL_FWD, REL_GRAD = 1e-5, 1e-4


def voxels(seed, D=4):
    """[B, V, P, D] features with 1..P points per voxel (zeros after the
    count), the last V // 4 rows empty (padding), and the counts [B, V]."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, P + 1, size=(B, V)).astype(np.int32)
    counts[:, -V // 4:] = 0
    feats = rng.normal(0.0, 2.0, size=(B, V, P, D)).astype(np.float32)
    feats *= (np.arange(P)[None, None, :] < counts[..., None])[..., None]
    return feats, counts


@pytest.fixture(scope="module")
def transvfe():
    feats, counts = voxels(0)
    jm = jve.TransformerVoxelFeatureExtractor(**CFG)
    variables = random_variables(init_shapes(jm, feats, counts), seed=3)
    tm = tve.TransformerVoxelFeatureExtractor(**CFG)
    load_flax_variables(tm, variables)
    cot = np.random.default_rng(1).normal(
        size=(B, V, CFG["num_compressed_features"])).astype(np.float32)
    return dict(feats=feats, counts=counts, jm=jm, variables=variables,
                tm=tm, cot=cot)


def _torch_grads(tm, feats, counts, cot):
    x = t(feats).requires_grad_(True)
    tm.zero_grad(set_to_none=True)
    (tm(x, t(counts)) * t(cot)).sum().backward()
    return x.grad, {k: p.grad.clone() for k, p in tm.named_parameters()}


def test_transvfe_forward_matches(transvfe):
    r = transvfe
    want = r["jm"].apply(r["variables"], jnp.asarray(r["feats"]),
                         jnp.asarray(r["counts"]))
    with torch.no_grad():
        got = r["tm"](t(r["feats"]), t(r["counts"]))
    assert got.shape == (B, V, CFG["num_compressed_features"])
    assert_close_rel(got, want, REL_FWD, "TransVFE forward")
    # the padded voxel rows run through the encoder too (no mask): their
    # output is the same for every row, and equals JAX's
    assert_close_rel(got[:, -1], np.asarray(want)[:, -1], REL_FWD,
                     "padded rows")


def test_transvfe_gradients_match(transvfe):
    r = transvfe

    def f(params, x):
        out = r["jm"].apply({"params": params}, x, jnp.asarray(r["counts"]))
        return (out * jnp.asarray(r["cot"])).sum()

    gp, gx = jax.grad(f, argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, r["variables"]["params"]),
        jnp.asarray(r["feats"]))
    want = flax_params_to_named(r["tm"], jax.tree_util.tree_map(np.asarray,
                                                                gp))
    x_grad, got = _torch_grads(r["tm"], r["feats"], r["counts"], r["cot"])
    assert set(got) == set(want) and any(".1." in k for k in got)
    top = max(float(np.abs(n(w)).max()) for w in want.values())
    for k in want:
        if k.endswith("TorchLinear_1.bias") and "EncoderLayers" in k:
            assert max(float(np.abs(n(got[k])).max()),
                       float(np.abs(n(want[k])).max())) <= 1e-6 * top, k
            continue
        assert_close_rel(got[k], want[k], REL_GRAD, k)
    gx = np.asarray(gx)
    finite = np.isfinite(gx)
    assert finite.any() and torch.isfinite(x_grad).all()
    assert_close_rel(n(x_grad)[finite], gx[finite], REL_GRAD, "features")


def test_checkpoint_on_and_off_give_equal_gradients(transvfe, monkeypatch):
    r = transvfe
    on_x, on = _torch_grads(r["tm"], r["feats"], r["counts"], r["cot"])
    # the layers called plainly: autograd stores their activations
    monkeypatch.setattr(tve.remat, "remat", lambda fn, *args: fn(*args))
    off_x, off_g = _torch_grads(r["tm"], r["feats"], r["counts"], r["cot"])
    assert torch.equal(on_x, off_x)
    for k in on:
        assert torch.equal(on[k], off_g[k]), k


def test_checkpoint_recomputes_each_layer(transvfe, monkeypatch):
    """In training each encoder layer runs once in the forward and once
    more in the backward; without gradients it runs once."""
    r = transvfe
    calls = []
    layer = r["tm"].EncoderLayers[0]
    real = type(layer).forward
    monkeypatch.setattr(type(layer), "forward",
                        lambda self, x: calls.append(1) or real(self, x))
    _torch_grads(r["tm"], r["feats"], r["counts"], r["cot"])
    assert len(calls) == 2 * CFG["num_layers"]
    calls.clear()
    with torch.no_grad():
        r["tm"](t(r["feats"]), t(r["counts"]))
    assert len(calls) == CFG["num_layers"]


def test_token_attention_matches_custom_vjp():
    rng = np.random.default_rng(7)
    q, k, v, co = (rng.normal(size=(64, P, 32)).astype(np.float32)
                   for _ in range(4))
    nhead = 4
    want = jve.tiny_token_attention(*map(jnp.asarray, (q, k, v)), nhead)
    jg = jax.grad(lambda a, b, c: (jve.tiny_token_attention(a, b, c, nhead)
                                   * co).sum(), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (t(a).requires_grad_(True) for a in (q, k, v))
    got = tve.token_attention(tq, tk, tv, nhead)
    (got * t(co)).sum().backward()
    assert_close_rel(got, want, REL_FWD, "attention")
    for name, g, w in zip("qkv", (tq.grad, tk.grad, tv.grad), jg):
        assert_close_rel(g, w, REL_GRAD, f"d{name}")


def test_encoder_layers_unstack_strictly(transvfe):
    r = transvfe
    sd = flax_to_state_dict(r["tm"], r["variables"])
    layers = {k.split(".")[1] for k in sd if k.startswith("EncoderLayers.")}
    assert layers == {"0", "1"}
    stacked = r["variables"]["params"]["EncoderLayers"][
        "TransformerEncoderLayerPreNorm_0"]
    np.testing.assert_array_equal(
        n(sd["EncoderLayers.1.TorchLinear_4.weight"]),
        np.asarray(stacked["TorchLinear_4"]["kernel"][1]).T)
    np.testing.assert_array_equal(
        n(sd["EncoderLayers.0.LayerNorm_1.weight"]),
        np.asarray(stacked["LayerNorm_1"]["scale"][0]))
    # a model with one layer fewer leaves the second layer's leaves over
    short = tve.TransformerVoxelFeatureExtractor(**dict(CFG, num_layers=1))
    with pytest.raises(ValueError, match="not consumed"):
        flax_to_state_dict(short, r["variables"])
    # and one with a layer more is not fully assigned
    long = tve.TransformerVoxelFeatureExtractor(**dict(CFG, num_layers=3))
    with pytest.raises(ValueError, match="not assigned"):
        flax_to_state_dict(long, r["variables"])


@pytest.mark.parametrize("D", [4, 5])
def test_mean_vfe_matches(D):
    feats, counts = voxels(11, D)
    want = jve.MeanVoxelFeatureExtractor(num_input_features=D).apply(
        {}, jnp.asarray(feats), jnp.asarray(counts))
    got = tve.MeanVoxelFeatureExtractor(num_input_features=D)(
        t(feats), t(counts))
    assert_close_rel(got, want, REL_FWD, "MeanVFE")
    with pytest.raises(ValueError):
        tve.MeanVoxelFeatureExtractor(num_input_features=D + 1)(
            t(feats), t(counts))
