"""The conv's backward interface: ``rulebook_conv`` / ``rulebook_conv_plain``
with ``flip_taps`` (read rb[K-1-k]), ``w_t`` (read w[k] as [Cout, Cin]),
``miss`` (a miss index the feature table does not store) and ``zero_row``
(a flat output with a last row of zeros), which let
``RulebookConvFn.backward`` compute dX with no copy of the rulebook, the
weights or the cotangent; and the host-side launch arithmetic of both
kernels. The dX / dW values against jax.grad and the interpreted Pallas
VJP are in test_torch_port_conv_backward.py.

Tolerance: fp32, max |err| <= 1e-6 * max |reference| where the same
products are summed in the same order but a matmul takes a transposed
view instead of a contiguous copy."""

import numpy as np
import pytest
import torch

from lidarseg3d_torch.ops import rulebook_conv as rc
from lidarseg3d_torch.ops import sparse as tsp

from _torch_port_helpers import assert_close_rel, t

REL = 1e-6
GRID = (8, 16, 16)


def _books(B, V=512, density=0.2, seed=0):
    """subm / strided / inverse rulebooks of one random structure: kind ->
    (rb, rb_t or None, v_in, v_out)."""
    rng = np.random.default_rng(seed)
    Z, Y, X = GRID
    rows, nums = [], []
    for _ in range(B):
        nv = min(V - 7, int(Z * Y * X * density))
        keys = np.sort(rng.choice(Z * Y * X, size=nv, replace=False))
        c = np.stack([keys // (Y * X), (keys // X) % Y, keys % X], -1)
        rows.append(np.concatenate([c, np.full((V - nv, 3), -1)]))
        nums.append(nv)
    s1 = tsp.build_structure(t(np.stack(rows).astype(np.int32)),
                             t(np.array(nums, np.int32)), GRID)
    t1 = tsp.dense_table(s1)
    s2 = tsp.downsample_structure(s1, 2, capacity=V // 2)
    down = tsp.build_strided_rulebook(s1, s2, table=t1)
    inv = tsp.build_inverse_rulebook(s2, s1)
    return dict(subm=(tsp.build_subm_rulebook(s1, table=t1), None, V, V),
                down=(down, inv, V, V // 2), inv=(inv, down, V // 2, V))


@pytest.fixture(scope="module", params=[1, 2], ids=["B1", "B2"])
def books(request):
    return request.param, _books(request.param)


def _feat(rows, c, seed):
    """A flat feature table [rows + 1, c] with its zero row."""
    x = np.random.default_rng(seed).normal(size=(rows, c)).astype(np.float32)
    return tsp.flat_features(t(x)[None])


@pytest.mark.parametrize("flip,w_t", [(True, False), (False, True),
                                      (True, True)])
def test_plain_flags_equal_explicit_flip_and_transpose(books, flip, w_t):
    B, bk = books
    rb, _, v_in, _ = bk["down"]
    feat = _feat(B * v_in, 12, seed=1)
    w = t(np.random.default_rng(2).normal(size=(27, 12, 8)).astype(
        np.float32))
    w_arg = w.transpose(1, 2).contiguous() if w_t else w
    got = rc.rulebook_conv_plain(feat, rb, w_arg, flip_taps=flip, w_t=w_t)
    want = rc.rulebook_conv_plain(
        feat, rb.flip(0).contiguous() if flip else rb, w)
    assert got.shape == want.shape
    if w_t:
        assert_close_rel(got, want, REL, f"flip={flip} w_t")
    else:  # the same matmuls on the same operands
        assert torch.equal(got, want)
    # the CPU wrapper takes the plain version with the same flags
    assert torch.equal(rc.rulebook_conv(feat, rb, w_arg, flip_taps=flip,
                                        w_t=w_t), got)


def test_plain_miss_row_not_stored_and_zero_row(books):
    """miss = rows (the cotangent has no zero row) gathers zeros for it;
    zero_row returns the flat output with a last row of zeros."""
    B, bk = books
    rb, rb_t, v_in, v_out = bk["down"]
    g = _feat(B * v_out, 16, seed=3)[:-1]  # [B*v_out, 16], no zero row
    w = t(np.random.default_rng(4).normal(size=(27, 16, 8)).astype(
        np.float32))
    got = rc.rulebook_conv_plain(g, rb_t, w, miss=g.shape[0], zero_row=True)
    want = rc.rulebook_conv_plain(
        torch.cat([g, g.new_zeros(1, 16)]), rb_t, w)
    assert tuple(got.shape) == (B * v_in + 1, 8)
    assert torch.equal(got[:-1], want.reshape(-1, 8))
    assert not got[-1].any()
    with pytest.raises(ValueError, match="miss"):
        rc.rulebook_conv_plain(g, rb_t, w, miss=g.shape[0] + 1)


@pytest.mark.parametrize("kind", ["subm", "down", "inv"])
def test_backward_dx_matches_explicit_transpose_and_zero_row(books, kind):
    """RulebookConvFn's dX (flags, no copies) equals the conv of the
    cotangent, zero row appended, under the explicitly flipped or paired
    rulebook with contiguous W_k^T; the zero row of dfeat is zero."""
    B, bk = books
    rb, rb_t, v_in, v_out = bk[kind]
    rng = np.random.default_rng(5)
    ff = _feat(B * v_in, 12, seed=6).requires_grad_(True)
    w = t((rng.normal(size=(27, 12, 16)) / 18).astype(np.float32))
    g = t(rng.normal(size=(B, v_out, 16)).astype(np.float32))
    out = rc.RulebookConvFn.apply(ff, w, rb, rb_t)
    (out * g).sum().backward()
    book_t = rb.flip(0).contiguous() if rb_t is None else rb_t
    g_rows = g.reshape(-1, 16)
    want = rc.rulebook_conv_plain(
        torch.cat([g_rows, g_rows.new_zeros(1, 16)]), book_t,
        w.transpose(1, 2).contiguous())
    assert tuple(ff.grad.shape) == tuple(ff.shape)
    assert not ff.grad[-1].any()
    assert_close_rel(ff.grad[:-1], want.reshape(-1, 12), REL, kind)


def test_conv_splits():
    """Every tap group holds at most CONV_MAX_TAPS taps and none is empty;
    wide inputs split (Cin / 64 groups), narrow ones do not."""
    for K in (1, 3, 27, 33, 64, 125):
        for cin in (4, 12, 32, 64, 128, 256, 1024):
            s = rc.conv_splits(K, cin)
            per = -(-K // s)
            assert 1 <= s <= K and per <= rc.CONV_MAX_TAPS
            assert (s - 1) * per < K
    assert [rc.conv_splits(27, c) for c in (12, 32, 64, 128, 256)] == \
        [1, 1, 1, 2, 4]


def test_dw_tiling_and_splits():
    """The dW tile holds at most 64 accumulators a thread (taps x CIT x
    COT / 128 threads), its tap groups are balanced and non-empty, and the
    row ranges are whole tiles that together cover M."""
    for cin, cout in [(12, 32), (32, 32), (32, 64), (64, 64), (64, 128),
                      (128, 128), (256, 128), (128, 64), (64, 32)]:
        cit, cot, groups = rc.dw_tiling(27, cin, cout)
        per = -(-27 // groups)
        assert per * cit * cot // 128 <= 64 and (groups - 1) * per < 27
        for M in (1, 31, 4096, 262144):
            n = rc.dw_splits(27, M, cin, cout)
            tiles = -(-M // rc.DW_TILE_M)
            assert 1 <= n <= tiles
    assert rc.dw_tiling(27, 12, 32) == (16, 32, 4)
    assert rc.dw_tiling(27, 256, 128) == (64, 64, 14)
