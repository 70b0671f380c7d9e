"""lidarseg3d_torch rulebook conv (the plain version of the rulebook_conv
kernel) against the JAX package's XLA gather-GEMM (_gather_gemm_core) and
its fused Pallas conv in interpret mode (sparse_pallas.fused_conv,
mode="fp32").

Tolerance: fp32, max |err| <= 1e-5 * max |reference| — the same products
summed in another order (per-tap matmuls vs one im2col GEMM)."""

import numpy as np
import jax.numpy as jnp
import pytest

from lidarseg3d_tpu.ops import sparse as jsp
from lidarseg3d_tpu.ops import sparse_pallas as spz
from lidarseg3d_torch.ops import sparse as tsp
from lidarseg3d_torch.ops.rulebook_conv import (rulebook_conv,
                                                rulebook_conv_plain)

from _torch_port_helpers import assert_close_rel, n, t

REL = 1e-5


def _structure(V, grid, density, seed):
    rng = np.random.default_rng(seed)
    Z, Y, X = grid
    nv = min(V - 7, int(Z * Y * X * density))
    keys = np.sort(rng.choice(Z * Y * X, size=nv, replace=False))
    c = np.stack([keys // (Y * X), (keys // X) % Y, keys % X], -1)
    c = np.concatenate([c, np.full((V - nv, 3), -1)]).astype(np.int32)[None]
    return c, np.array([nv], np.int32)


@pytest.fixture(scope="module")
def books():
    grid, V = (8, 16, 16), 1024
    coords, num = _structure(V, grid, 0.3, 0)
    js = jsp.build_structure(jnp.asarray(coords), jnp.asarray(num), grid)
    ts = tsp.build_structure(t(coords), t(num), grid)
    jt, tt = jsp.dense_table(js), tsp.dense_table(ts)
    js2 = jsp.downsample_structure(js, 2, capacity=V // 2)
    ts2 = tsp.downsample_structure(ts, 2, capacity=V // 2)
    rb = dict(
        subm=(jsp.build_subm_rulebook(js, table=jt),
              tsp.build_subm_rulebook(ts, table=tt)),
        down=(jsp.build_strided_rulebook(js, js2, table=jt),
              tsp.build_strided_rulebook(ts, ts2, table=tt)),
        inv=(jsp.build_inverse_rulebook(js2, js),
             tsp.build_inverse_rulebook(ts2, ts)),
    )
    for k, (a, b) in rb.items():
        np.testing.assert_array_equal(n(b), n(a), err_msg=k)
    return rb, V, int(num[0]), int(ts2.num_voxels[0])


@pytest.mark.parametrize("cin,cout", [(12, 16), (32, 32), (64, 24)])
def test_plain_conv_matches_gather_gemm(books, cin, cout):
    rb, V, nv, _ = books
    rng = np.random.default_rng(cin)
    feats = rng.normal(size=(1, V, cin)).astype(np.float32)
    feats[:, nv:] = 0
    w = (rng.normal(size=(27, cin, cout)) / np.sqrt(27 * cin)).astype(
        np.float32)
    for kind in ("subm", "down"):
        jrb, trb = rb[kind]
        want = jsp._gather_gemm_core(jsp._flat_features(jnp.asarray(feats)),
                                     jrb, jnp.asarray(w))
        ff = tsp.flat_features(t(feats))
        got = rulebook_conv_plain(ff, trb, t(w))
        assert_close_rel(got, want, REL, kind)
        # the CPU wrapper takes the plain version
        np.testing.assert_array_equal(n(rulebook_conv(ff, trb, t(w))),
                                      n(got))


@pytest.mark.parametrize("kind", ["subm", "down", "inv"])
def test_plain_conv_matches_interpreted_pallas(books, kind):
    rb, V, nv, nv2 = books
    jrb, trb = rb[kind]
    v_in = V // 2 if kind == "inv" else V
    n_valid = nv2 if kind == "inv" else nv
    cin, cout = 16, 32
    rng = np.random.default_rng(7)
    feats = rng.normal(size=(1, v_in, cin)).astype(np.float32)
    feats[:, n_valid:] = 0
    w = (rng.normal(size=(27, cin, cout)) / np.sqrt(27 * cin)).astype(
        np.float32)
    # strided <-> inverse are each other's transposes (the fused conv's
    # backward rulebook); subm derives its own
    pair = {"subm": None, "down": rb["inv"][0], "inv": rb["down"][0]}[kind]
    want = spz.fused_conv(jnp.asarray(feats), jnp.asarray(w), jrb, pair,
                          mode="fp32", interpret=True)
    got = rulebook_conv_plain(tsp.flat_features(t(feats)), trb, t(w))
    assert_close_rel(got, want, REL, kind)


def test_conv_modules_match_jax_ops(books):
    """subm_conv / strided_conv / inverse_conv of both packages (XLA
    path) on the same rulebooks."""
    rb, V, nv, nv2 = books
    rng = np.random.default_rng(9)
    x = rng.normal(size=(1, V, 8)).astype(np.float32)
    x2 = rng.normal(size=(1, V // 2, 8)).astype(np.float32)
    w = (rng.normal(size=(27, 8, 16)) / 8).astype(np.float32)
    jst = jsp.SparseTensor(structure=None, features=jnp.asarray(x))
    jst2 = jsp.SparseTensor(structure=None, features=jnp.asarray(x2))
    tst = tsp.SparseTensor(structure=None, features=t(x))
    tst2 = tsp.SparseTensor(structure=None, features=t(x2))
    pairs = [
        (jsp.subm_conv(jst, jnp.asarray(w), rulebook=rb["subm"][0]),
         tsp.subm_conv(tst, t(w), rb["subm"][1])),
        (jsp.strided_conv(jst, None, jnp.asarray(w), rulebook=rb["down"][0]),
         tsp.strided_conv(tst, t(w), rb["down"][1])),
        (jsp.inverse_conv(jst2, None, jnp.asarray(w), rulebook=rb["inv"][0]),
         tsp.inverse_conv(tst2, t(w), rb["inv"][1])),
    ]
    for i, (want, got) in enumerate(pairs):
        assert_close_rel(got, want, REL, str(i))
