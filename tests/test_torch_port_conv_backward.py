"""lidarseg3d_torch's rulebook conv backward (RulebookConvFn on the CPU: dX
by the plain conv under the transposed rulebook, dW by
rulebook_conv_dw_plain) against the JAX package: jax.grad of its XLA
gather-GEMM, the custom VJP of its fused Pallas conv in interpret mode
(sparse_pallas.fused_conv, mode="fp32"), and pallas_conv.rulebook_conv_dw
in interpret mode; plus torch.autograd.gradcheck in float64 and the
transpose property the backward rests on.

Tolerance: fp32, max |err| <= 1e-5 * max |reference| against the XLA
autodiff (the same products summed in another order), and 1e-4 against
the interpreted Pallas kernels, whose dW accumulates 128-row blocks in
sequence."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lidarseg3d_tpu.ops import pallas_conv as pc
from lidarseg3d_tpu.ops import sparse as jsp
from lidarseg3d_tpu.ops import sparse_pallas as spz
from lidarseg3d_torch.ops import sparse as tsp
from lidarseg3d_torch.ops.rulebook_conv import (RulebookConvFn,
                                                rulebook_conv_dw,
                                                rulebook_conv_dw_plain)

from _torch_port_helpers import assert_close_rel, n, t

REL_XLA = 1e-5
REL_PALLAS = 1e-4
GRID = (8, 16, 16)
KINDS = ("subm", "down", "inv")


def _coords(B, V, density, seed):
    rng = np.random.default_rng(seed)
    Z, Y, X = GRID
    rows, nums = [], []
    for _ in range(B):
        nv = min(V - 7, int(Z * Y * X * density))
        keys = np.sort(rng.choice(Z * Y * X, size=nv, replace=False))
        c = np.stack([keys // (Y * X), (keys // X) % Y, keys % X], -1)
        rows.append(np.concatenate([c, np.full((V - nv, 3), -1)]))
        nums.append(nv)
    return np.stack(rows).astype(np.int32), np.array(nums, np.int32)


def _books(B, V=512, density=0.2, seed=0):
    """Both packages' subm / strided / inverse rulebooks on one random
    structure: dict kind -> (jax rb, torch rb, torch rb_t, v_in, v_out)."""
    coords, num = _coords(B, V, density, seed)
    js = jsp.build_structure(jnp.asarray(coords), jnp.asarray(num), GRID)
    ts = tsp.build_structure(t(coords), t(num), GRID)
    jt, tt = jsp.dense_table(js), tsp.dense_table(ts)
    js2 = jsp.downsample_structure(js, 2, capacity=V // 2)
    ts2 = tsp.downsample_structure(ts, 2, capacity=V // 2)
    jr = dict(subm=jsp.build_subm_rulebook(js, table=jt),
              down=jsp.build_strided_rulebook(js, js2, table=jt),
              inv=jsp.build_inverse_rulebook(js2, js))
    tr = dict(subm=tsp.build_subm_rulebook(ts, table=tt),
              down=tsp.build_strided_rulebook(ts, ts2, table=tt),
              inv=tsp.build_inverse_rulebook(ts2, ts))
    for k in KINDS:
        np.testing.assert_array_equal(n(tr[k]), n(jr[k]), err_msg=k)
    pair = dict(subm=None, down="inv", inv="down")
    sizes = dict(subm=(V, V), down=(V, V // 2), inv=(V // 2, V))
    return {k: (jr[k], tr[k], None if pair[k] is None else tr[pair[k]],
                None if pair[k] is None else jr[pair[k]], *sizes[k])
            for k in KINDS}


@pytest.fixture(scope="module", params=[1, 2], ids=["B1", "B2"])
def books(request):
    B = request.param
    return B, _books(B)


def _inputs(B, v_in, v_out, cin, cout, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, v_in, cin)).astype(np.float32)
    w = (rng.normal(size=(27, cin, cout)) / np.sqrt(27 * cin)).astype(
        np.float32)
    g = rng.normal(size=(B, v_out, cout)).astype(np.float32)
    return x, w, g


def _torch_grads(x, w, g, rb, rb_t):
    xt = t(x).requires_grad_(True)
    wt = t(w).requires_grad_(True)
    out = tsp._conv(xt, wt, rb, rb_t)
    (out * t(g)).sum().backward()
    return out, xt.grad, wt.grad


@pytest.mark.parametrize("kind", KINDS)
def test_backward_matches_jax_grad_of_gather_gemm(books, kind):
    B, bk = books
    jrb, trb, trb_t, _, v_in, v_out = bk[kind]
    x, w, g = _inputs(B, v_in, v_out, 12, 16, seed=1)

    def loss(xj, wj):
        out = jsp._gather_gemm_core(jsp._flat_features(xj), jrb, wj)
        return jnp.sum(out * jnp.asarray(g))

    gx, gw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    _, dx, dw = _torch_grads(x, w, g, trb, trb_t)
    assert_close_rel(dx, gx, REL_XLA, f"dX {kind}")
    assert_close_rel(dw, gw, REL_XLA, f"dW {kind}")


@pytest.mark.parametrize("kind", KINDS)
def test_backward_matches_interpreted_pallas_vjp(books, kind):
    B, bk = books
    jrb, trb, trb_t, jrb_t, v_in, v_out = bk[kind]
    x, w, g = _inputs(B, v_in, v_out, 16, 8, seed=2)

    def loss(xj, wj):
        out = spz.fused_conv(xj, wj, jrb, jrb_t, mode="fp32", interpret=True)
        return jnp.sum(out * jnp.asarray(g))

    # under jit the interpreted kernels trace once into XLA loops instead
    # of stepping their grids op by op in Python
    gx, gw = jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(x),
                                                     jnp.asarray(w))
    _, dx, dw = _torch_grads(x, w, g, trb, trb_t)
    assert_close_rel(dx, gx, REL_PALLAS, f"dX {kind}")
    assert_close_rel(dw, gw, REL_PALLAS, f"dW {kind}")


@pytest.mark.parametrize("kind", KINDS)
def test_dw_plain_matches_interpreted_pallas_dw(kind):
    """rulebook_conv_dw_plain against pallas_conv.rulebook_conv_dw at the
    TPU kernel's own layout (transposed table, MISS sentinel, 128-padded
    rows), B = 1."""
    jrb, trb, _, _, v_in, v_out = _books(1, seed=3)[kind]
    x, _, g = _inputs(1, v_in, v_out, 16, 16, seed=4)
    gidx = spz.kernel_rulebook(jrb, v_in)
    want = pc.rulebook_conv_dw(jnp.asarray(x[0].T), gidx, jnp.asarray(g[0]),
                               interpret=True)
    ff = tsp.flat_features(t(x))
    got = rulebook_conv_dw_plain(ff, trb, t(g[0]))
    assert got.dtype == torch.float32 and tuple(got.shape) == (27, 16, 16)
    assert_close_rel(got.reshape(27 * 16, 16), want, REL_PALLAS, kind)
    # the CPU wrapper takes the plain version
    np.testing.assert_array_equal(n(rulebook_conv_dw(ff, trb, t(g[0]))),
                                  n(got))


@pytest.mark.parametrize("kind", KINDS)
def test_rulebooks_are_exact_transposes(books, kind):
    """rb_t[k][i] == j  <=>  rb[k][j] == i, tap by tap: subm against its
    own flip, strided and inverse against each other."""
    B, bk = books
    _, rb, rb_t, _, v_in, v_out = bk[kind]
    if rb_t is None:
        rb_t = rb.flip(0)
    rb, rb_t = n(rb).reshape(27, -1), n(rb_t).reshape(27, -1)
    miss, miss_t = B * v_in, B * v_out
    assert rb.shape[1] == miss_t and rb_t.shape[1] == miss
    pairs = 0
    for k in range(27):
        j = np.nonzero(rb[k] != miss)[0]
        i = np.nonzero(rb_t[k] != miss_t)[0]
        fwd = set(zip(rb[k][j].tolist(), j.tolist()))
        bwd = set(zip(i.tolist(), rb_t[k][i].tolist()))
        assert fwd == bwd, (kind, k)
        pairs += len(fwd)
    assert pairs > 0


@pytest.mark.parametrize("kind", KINDS)
def test_gradcheck_float64(kind):
    _, rb, rb_t, _, v_in, v_out = _books(1, V=64, density=0.02, seed=5)[kind]
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(1, v_in, 3))).requires_grad_(True)
    w = torch.from_numpy(rng.normal(size=(27, 3, 2))).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda a, b: tsp._conv(a, b, rb, rb_t), (x, w), eps=1e-6, atol=1e-7)


def test_no_dx_when_input_needs_no_gradient():
    """conv_input's features need no gradient: the backward must give dW
    and launch no dX conv."""
    _, rb, _, _, v_in, _ = _books(1, seed=7)["subm"]
    x, w, g = _inputs(1, v_in, v_in, 4, 8, seed=8)
    ff = tsp.flat_features(t(x))
    wt = t(w).requires_grad_(True)
    out = RulebookConvFn.apply(ff, wt, rb, None)
    (out * t(g)).sum().backward()
    assert wt.grad is not None and ff.grad is None
    assert_close_rel(wt.grad, rulebook_conv_dw_plain(ff, rb, t(g[0])),
                     1e-6, "dW")


def test_strided_conv_under_autograd_needs_its_pair():
    _, rb, _, _, v_in, _ = _books(1, seed=7)["down"]
    x, w, _ = _inputs(1, v_in, v_in // 2, 4, 8, seed=9)
    st = tsp.SparseTensor(structure=None, features=t(x))
    with pytest.raises(ValueError, match="paired"):
        tsp.strided_conv(st, t(w).requires_grad_(True), rb)
    with torch.no_grad():
        tsp.strided_conv(st, t(w), rb)  # inference needs no pair
