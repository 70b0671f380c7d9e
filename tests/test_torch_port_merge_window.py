"""The merge kernel (csrc/merge_lookup.cu), emulated in numpy tile by tile
and held against merge_cells_plain, exactly: each tile's smallest and
largest query, the key window their block ranks bracket (cut to the
kernel's capacity), the in-window test of each query's own bracket, the
interleaved branch-free searches over powers of two (in the window, or in
device memory for a query outside it) and the neighbour bits decided from
the three keys below each search's result. A query served from the window
reads only window positions (the emulation indexes a copy of the window).
Three streams: the main path's subm query streams on a small KeyTable
(each query coordinate clamped into the grid, as the rulebook front end
``rank_lookup.rulebook_cells`` hands them to the kernel), the same streams
shuffled, and rows whose tails are clamped to the row's largest cell; and
the semnusc path's own streams at full size, where every tile but those
at a row's padding is served from its window.
The kernel runs only on the card (chip_smoke.py phase 4)."""

import numpy as np
import pytest

from lidarseg3d_torch import synthetic as syn
from lidarseg3d_torch.ops import coords as tco
from lidarseg3d_torch.ops import merge_lookup as ml
from lidarseg3d_torch.ops import sparse as tsp
from lidarseg3d_torch.ops.rank_lookup import rulebook_cells

from _torch_port_helpers import n, t

NONE = -(2**40)  # a key value that equals no cell


def _bracket(q, cb, nb, shift, nk):
    """Each query's [l, h]: #{valid keys <= q+1} lies between them."""
    qp = q + 1
    j = np.where(qp >= 0, qp >> shift, 0)
    inside = (qp >= 0) & (j < nb)
    lo = np.where(qp < 0, 0, nk)
    hi = lo.copy()
    lo[inside] = np.minimum(cb[j[inside]], nk)
    hi[inside] = np.minimum(cb[j[inside] + 1], nk)
    return lo, hi


def emulate_merge(keys, coarse, shift, num, cells, threads=ml.THREADS,
                  kper=ml.KPER, window=ml.WINDOW):
    """The kernel's result, each query's bracket width, and its counters
    (ml.PATHS: tiles served wholly, partly, not at all from their window;
    queries searched in device memory)."""
    G, B, V = cells.shape
    nb = coarse.shape[1] - 1
    tile = threads * kper
    out = np.zeros(cells.shape, np.int64)
    widths = np.zeros(cells.shape, np.int64)
    paths = np.zeros(4, np.int64)
    for g in range(G):
        for b in range(B):
            k = keys[b].astype(np.int64)
            cb = coarse[b].astype(np.int64)
            nk = int(np.clip(num[b], 0, keys.shape[1]))
            for v0 in range(0, V, tile):
                q = cells[g, b, v0:v0 + tile].astype(np.int64)
                qp = q + 1
                lo, hi = _bracket(q, cb, nb, shift, nk)
                true_pos = np.searchsorted(k[:nk], qp, side="right")
                assert np.all((lo <= true_pos) & (true_pos <= hi))
                wl, _ = _bracket(q.min(keepdims=True), cb, nb, shift, nk)
                _, wh = _bracket(q.max(keepdims=True), cb, nb, shift, nk)
                w0 = max(int(wl[0]) - 3, 0)
                w1 = min(int(wh[0]), w0 + window)
                staged = k[w0:w1].copy()
                win = hi <= w1
                assert np.all(lo - 3 >= w0) or w0 == 0

                def key(pos, mask):  # keys at positions, from where read
                    pos = np.where(mask, pos, 0)
                    got = k[np.clip(pos, 0, len(k) - 1)]
                    if np.any(mask & win):
                        w = pos[mask & win] - w0
                        assert np.all((w >= 0) & (w < len(staged)))
                        got[mask & win] = staged[w]
                    return got

                cnt = hi - lo
                tid = np.arange(len(q)) % threads  # kper queries a thread
                widest = np.zeros(threads, np.int64)
                np.maximum.at(widest, tid, cnt)
                step = np.where(widest[tid] > 0, 1 << np.floor(np.log2(
                    np.maximum(widest[tid], 1))).astype(np.int64), 0)
                pos = np.zeros(len(q), np.int64)
                while np.any(step > 0):
                    p = pos + step
                    ok = (step > 0) & (p <= cnt)
                    pos = np.where(ok & (key(lo + p - 1, ok) <= qp), p, pos)
                    step >>= 1
                P = lo + pos

                def below(d):
                    return np.where(P >= d, key(P - d, P >= d), NONE)

                x1, x2, x3 = below(1), below(2), below(3)
                ap = (x1 == qp).astype(np.int64)
                y1, y2 = np.where(ap, x2, x1), np.where(ap, x3, x2)
                a0 = (y1 == q).astype(np.int64)
                am = (np.where(a0, y2, y1) == q - 1).astype(np.int64)
                out[g, b, v0:v0 + tile] = (((P - ap) << 3) | (am << 2)
                                           | (a0 << 1) | ap)
                widths[g, b, v0:v0 + tile] = cnt
                paths[0 if win.all() else 2 if not win.any() else 1] += 1
                paths[3] += int((~win).sum())
    return out.astype(np.int32), widths, paths


def _structure(seed, shape=(6, 40, 60), V=1500, nvox=(1200, 700)):
    """B=2 key-sorted voxel sets with padding rows and voxels on the top
    z layer (their dz=+1 queries leave the grid and are clamped)."""
    rng = np.random.default_rng(seed)
    Z, Y, X = shape
    zyx = np.full((2, V, 3), -1, np.int32)
    nv = np.zeros(2, np.int32)
    for b in range(2):
        keys = np.unique(np.concatenate([
            rng.integers(0, Z * Y * X, 4 * nvox[b]),
            (Z - 1) * Y * X + rng.integers(0, Y * X, 50)]))
        keys = np.sort(rng.permutation(keys)[:nvox[b]])
        nv[b] = len(keys)
        zyx[b, :nv[b]] = np.stack([keys // (Y * X), (keys // X) % Y,
                                   keys % X], -1)
    return tsp.build_structure(t(zyx), t(nv), shape)


def _subm_stream(s, shift):
    table = tco.build_key_table(s.coords, s.num_voxels, s.spatial_shape,
                                shift=shift)
    return table, rulebook_cells(s.coords, s.num_voxels,
                                 tsp.subm_spec(table, s))


def _streams(kind, seed, shift):
    table, cells = _subm_stream(_structure(seed), shift)
    if kind == "shuffled":
        rng = np.random.default_rng(seed + 1)
        c = n(cells)
        cells = t(c[..., rng.permutation(c.shape[-1])].copy())
    elif kind == "clamped_tails":
        c = n(cells).copy()
        c[..., 3 * c.shape[-1] // 4:] = c.max(-1, keepdims=True)
        cells = t(c)
    return table, cells


@pytest.mark.parametrize("shift", [3, 12])
@pytest.mark.parametrize("kind", ["subm", "shuffled", "clamped_tails"])
@pytest.mark.parametrize("threads,kper,window", [
    (ml.THREADS, ml.KPER, ml.WINDOW),  # the kernel's own sizes
    (32, 3, 64)])  # small tiles and windows: cut windows, mixed tiles
def test_kernel_search_equals_plain(kind, shift, threads, kper, window):
    table, cells = _streams(kind, 0, shift)
    got, _, paths = emulate_merge(n(table.keys), n(table.coarse),
                                  table.shift, n(table.num), n(cells),
                                  threads, kper, window)
    want = ml.merge_cells_plain(table.keys, table.num, cells)
    np.testing.assert_array_equal(got, n(want))
    G, B, V = cells.shape
    assert paths[:3].sum() == G * B * -(-V // (threads * kper))
    if kind == "shuffled" and window < 1000:  # a tile spans every key
        assert paths[0] == 0 and paths[3] > cells.numel() // 2
    if kind == "subm" and window == ml.WINDOW:  # sorted: all tiles but
        assert paths[1] + paths[2] <= G * B  # the one at a row's padding


def test_semnusc_streams():
    """The semnusc path's subm streams on its KeyTable stages (a synthetic
    scan at V=40960 on the 41 x 1024 x 1024 grid, stage 1 and its 2x
    downsampled stage 2), sorted as the path sends them: the kernel's
    result equals the plain version; every tile is served from its window
    but at most two a row, where queries that left the grid are clamped to
    its first cells (a row's first tile) or the row ends in padding, whose
    cells are 0 (the tile at its last voxels); and a search spans the
    keys of one 4096-cell block (that of q+1)."""
    nu = syn.SEMNUSC
    b = syn.synthetic_batch(1, nu["V"], nu["N"], pcr=nu["pcr"],
                            vsz=nu["vsz"])
    s1 = tsp.build_structure(t(b["coordinates"]), t(b["num_voxels"]),
                             syn.grid_shape(nu["pcr"], nu["vsz"]))
    s2 = tsp.downsample_structure(s1, 2, capacity=nu["V"] // 2, padding=1)
    for s in (s1, s2):
        assert tsp.table_kind(s.spatial_shape) == "keys"
        table, cells = _subm_stream(s, 12)
        got, widths, paths = emulate_merge(n(table.keys), n(table.coarse),
                                           12, n(table.num), n(cells))
        np.testing.assert_array_equal(
            got, n(ml.merge_cells_plain(table.keys, table.num, cells)))
        G, B, _ = cells.shape
        assert paths[1] + paths[2] <= 2 * G * B and paths[0] > 0
        # a bracket holds the keys of one 4096-cell block: about a hundred
        # on average at stage 1, where the ground is dense
        assert 0 < widths.mean() < 256 and widths.max() < 4096
