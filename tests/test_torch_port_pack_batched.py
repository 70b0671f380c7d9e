"""The batched rank-table pack (ops/rank_pack.py) on [B, NCE + 1] activity
bitmaps read in place: its plain version against the JAX package's Pallas
pack kernel (interpret mode, one sample at a time) and build_rank_table,
bit for bit, at table sizes around the CUDA kernel's tile; and a numpy
emulation of that kernel's tiling (flat output windows split at row edges,
16-byte staging of unaligned rows with masked halos, eight 4-cell groups
a thread, the empty-tile path, a prefix over the row's earlier tiles)
against the plain version. The kernel itself runs only on the card
(chip_smoke.py phase 4)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lidarseg3d_tpu.ops import coords as jco
from lidarseg3d_tpu.ops import pallas_rank
from lidarseg3d_torch.ops import coords as tco
from lidarseg3d_torch.ops import rank_pack as rp

from _torch_port_helpers import n, t

TILE = rp.TILE
THREADS = rp.THREADS
GROUPS = TILE // (4 * THREADS)  # 4-cell groups a thread (kGroups)


def _row_cells(nce, seed):
    """Active cells of one row: dense tiles 0 and 2 around an empty tile 1,
    cells on every tile edge, and a sparse rest (the x-extended grid's
    first and last cell stay inactive, as for real voxels)."""
    rng = np.random.default_rng(seed)
    c = set(np.flatnonzero(rng.random(nce) < 0.02).tolist())
    for tile in (0, 2):
        lo, hi = tile * TILE, min((tile + 1) * TILE, nce)
        c |= set((lo + np.flatnonzero(rng.random(max(hi - lo, 0)) < 0.6))
                 .tolist())
    c -= set(range(TILE, 2 * TILE))
    c |= {e + d for e in range(2 * TILE, nce + 1, TILE) for d in (-1, 0)}
    c |= {TILE - 1}  # the last cell before the empty tile
    return np.array(sorted(x for x in c if 1 <= x <= nce - 2))


def _voxels(nce):
    """B=2 voxel sets on a 1 x 1 x (NCE - 2) grid (so the x-extended table
    has NCE cells), -1 padded: the padding rows scatter to the scratch
    cell NCE, which the pack must not read."""
    rows = [_row_cells(nce, s) for s in (0, 1)]
    V = max(len(r) for r in rows) + 7
    coords = np.full((2, V, 3), -1, np.int32)
    for b, r in enumerate(rows):
        coords[b, :len(r)] = np.stack([0 * r, 0 * r, r - 1], -1)
    num = np.array([len(r) for r in rows], np.int32)
    return coords, num, (1, 1, nce - 2)


NCES = [TILE - 1, TILE, TILE + 1, 3 * TILE - 1, 3 * TILE, 3 * TILE + 1]


@pytest.mark.parametrize("nce", NCES)
def test_batched_pack_matches_pallas_and_build_rank_table(nce):
    coords, num, shape = _voxels(nce)
    act = tco.activity(t(coords), t(num), shape)
    assert tuple(act.shape) == (2, nce + 1) and bool((act[:, nce] == 1).all())
    got = rp.pack_rank_table(act, nce)
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, nce)
    for b in range(2):
        want = pallas_rank.pack_rank_table(jnp.asarray(n(act)[b, :nce]),
                                           interpret=True)
        np.testing.assert_array_equal(n(got)[b], n(want))
    jt = jco.build_rank_table(jnp.asarray(coords), jnp.asarray(num), shape,
                              use_pallas=False)
    tt = tco.build_rank_table(t(coords), t(num), shape)
    np.testing.assert_array_equal(n(tt.packed), n(jt.packed))
    np.testing.assert_array_equal(n(got), n(jt.packed))
    if nce >= 3 * TILE:  # the empty tile holds the rank of its predecessor
        mid = n(got)[:, TILE:2 * TILE]
        assert np.all(mid[:, 1:-1] >> 3 == mid[:, :1] >> 3)


def test_pack_row_alone_equals_row_of_batched():
    """Each row is ranked from zero: a row packed alone (a [1, L] view of
    the bitmap) equals that row of the batched pack; no cells, no rows."""
    coords, num, shape = _voxels(3 * TILE + 1)
    act = tco.activity(t(coords), t(num), shape)
    nce = act.shape[1] - 1
    batched = rp.pack_rank_table(act, nce)
    for b in range(2):
        assert torch.equal(rp.pack_rank_table(act[b:b + 1], nce)[0],
                           batched[b])
    assert tuple(rp.pack_rank_table(act, 0).shape) == (2, 0)
    assert tuple(rp.pack_rank_table(act[:0], nce).shape) == (0, nce)


def _emulate_kernel(buf, base, stride, B, nce):
    """csrc/rank_pack.cu step by step on a byte buffer ``buf`` that sits at
    address ``base`` (its alignment is what the staging sees); row b at
    byte b * stride. Returns the flat [B * nce] output and how many tiles
    took the empty path."""
    out = np.full(B * nce, -1, np.int64)
    tiles = rp.tile_count(B, nce)
    totals, empties = {}, 0
    for v in range(tiles):  # tickets in order: each predecessor has started
        first, b = 0, 0
        while b < B - 1:
            wf = b * nce // TILE
            cnt = ((b + 1) * nce - 1) // TILE - wf + 1
            if v < first + cnt:
                break
            first += cnt
            b += 1
        w = b * nce // TILE + (v - first)
        e0, rlo, rhi = w * TILE, b * nce, (b + 1) * nce
        row = base + b * stride
        a_first = row + (e0 - rlo - 1)
        a_base = a_first & ~15
        off = a_first - a_base + 1
        nchunk = (off + TILE + 1 + 15) >> 4
        assert 1 <= off <= 16 and nchunk * 16 <= TILE + 32
        # thread t's group k: tile cells 4 * (k * THREADS + t) + [0, 4)
        addr = a_base + np.arange(nchunk * 16)
        inside = (addr >= row) & (addr < row + nce)
        raw = np.zeros(nchunk * 16 + 16, np.int64)
        raw[:nchunk * 16][inside] = buf[addr[inside] - base]
        cell = 4 * (np.arange(GROUPS)[:, None] * THREADS
                    + np.arange(THREADS)[None, :])  # [group k, thread]
        g = raw[off + cell[..., None] + np.arange(4)]  # [k, thread, 4]
        total = int(g.sum())
        excl = sum(totals[u] for u in range(first, v))  # the look-back
        totals[v] = total
        if total == 0:
            empties += 1
            o = np.full((GROUPS, THREADS, 4), excl << 3, np.int64)
            o[0, 0, 0] |= raw[off - 1] << 2
            o[-1, -1, 3] |= raw[off + TILE]
        else:
            c = g.sum(-1)  # [k, thread]
            colsum = c.sum(1)
            excl_k = (np.cumsum(c, 1) - c
                      + (np.cumsum(colsum) - colsum)[:, None])
            rank = excl + excl_k[..., None] + np.cumsum(g, -1)
            prev = raw[off + cell[..., None] + np.arange(4) - 1]
            nxt = raw[off + cell[..., None] + np.arange(4) + 1]
            o = (rank << 3) | (prev << 2) | (g << 1) | nxt
        e = e0 + cell[..., None] + np.arange(4)
        keep = (e >= rlo) & (e < rhi)
        assert np.all(out[e[keep]] == -1)  # no cell is written twice
        out[e[keep]] = o[keep]
    return out, empties


@pytest.mark.parametrize("base", [0, 7, 15])
@pytest.mark.parametrize("nce", [TILE - 1, TILE + 1, 3 * TILE + 1])
def test_kernel_emulation_matches_plain(nce, base):
    """The kernel's tiling over B=3 rows of the [B, NCE + 1] bitmap, each
    row starting at another alignment; every output cell written once."""
    coords, num, shape = _voxels(nce)
    act = n(tco.activity(t(coords), t(num), shape))
    act = np.concatenate([act, act[:1, ::-1]])  # a third row, scratch first
    B, stride = act.shape
    out, empties = _emulate_kernel(act.reshape(-1).astype(np.int64), base,
                                   stride, B, nce)
    want = n(rp.pack_rank_table_plain(t(act), nce)).reshape(-1)
    np.testing.assert_array_equal(out, want)
    if nce > 2 * TILE:  # row 0's empty middle tile (in rows 1 and 2 the
        assert empties >= 1  # windows are shifted off the empty run)


def test_tile_count_splits_windows_at_row_edges():
    assert rp.tile_count(1, TILE) == 1
    assert rp.tile_count(1, TILE + 1) == 2
    assert rp.tile_count(2, TILE) == 2
    # row 1 of 2 * (TILE + 1) cells starts one cell into window 1 and ends
    # one cell into window 2
    assert rp.tile_count(2, TILE + 1) == 4
    assert rp.tile_count(2, TILE // 2) == 2  # two rows share one window


def test_pack_wrapper_checks_before_any_launch():
    act = torch.zeros(2, 9, dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="device"):
        rp.pack_rank_table(act, 8)
    with pytest.raises(ValueError):
        rp.pack_rank_table_plain(torch.zeros(2, 2, 2, dtype=torch.int8), 2)
    with pytest.raises(ValueError, match="nce"):  # no 1-D form
        rp.pack_rank_table_plain(torch.zeros(9, dtype=torch.int8), 8)
    with pytest.raises(ValueError, match="nce"):  # more cells than a row
        rp.pack_rank_table(torch.zeros(2, 9, dtype=torch.int8), 10)
