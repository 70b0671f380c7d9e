"""lidarseg3d_torch's sorted-keys path against the JAX package, exactly:
KeyTable construction, the merge lookup's plain version against the
interpreted Pallas merge kernel, its XLA oracle and a RankTable gather,
the subm / strided / inverse rulebooks built on KeyTables, and the "auto"
table-kind rule."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lidarseg3d_tpu.ops import coords as jco
from lidarseg3d_tpu.ops import pallas_merge as jplm
from lidarseg3d_tpu.ops import sparse as jsp
from lidarseg3d_torch.ops import coords as tco
from lidarseg3d_torch.ops import sparse as tsp
from lidarseg3d_torch.ops.merge_lookup import merge_cells, merge_cells_plain
from lidarseg3d_torch.ops.rank_lookup import gather_cells_plain

from _torch_port_helpers import n, t


def _coords(rng, B, V, shape, nvox):
    """Key-sorted random voxel sets, -1 padded: ([B, V, 3] int32, [B])."""
    zyx = np.full((B, V, 3), -1, np.int32)
    nv = np.zeros(B, np.int32)
    for b in range(B):
        keys = np.unique(rng.integers(0, int(np.prod(shape)), 4 * V))
        keys = keys[:nvox[b]]
        nv[b] = len(keys)
        zyx[b, :nv[b]] = np.stack([keys // (shape[1] * shape[2]),
                                   (keys // shape[2]) % shape[1],
                                   keys % shape[2]], -1)
    return zyx, nv


def _tables(zyx, nv, shape):
    """(JAX KeyTable, port KeyTable, port RankTable) of one voxel set."""
    jk = jco.build_key_table(jnp.asarray(zyx), jnp.asarray(nv), shape)
    tk = tco.build_key_table(t(zyx), t(nv), shape)
    tr = tco.build_rank_table(t(zyx), t(nv), shape)
    return jk, tk, tr


def test_build_key_table_matches_jax():
    rng = np.random.default_rng(0)
    shape = (5, 40, 50)
    zyx, nv = _coords(rng, 2, 1500, shape, [1400, 333])
    jk, tk, _ = _tables(zyx, nv, shape)
    V = zyx.shape[1]
    assert n(jk.keys).shape[1] == 2048  # the TPU pads V to 1024s; no port
    np.testing.assert_array_equal(n(tk.keys), n(jk.keys)[:, :V])
    assert np.all(n(jk.keys)[:, V:] == tco.INVALID_KEY)
    np.testing.assert_array_equal(n(tk.coarse), n(jk.coarse))
    np.testing.assert_array_equal(n(tk.num), n(jk.num))
    assert tk.shift == jk.shift and tk.spatial_shape == jk.spatial_shape


def test_merge_plain_matches_pallas_kernel_and_xla_oracle():
    """Sorted 1024-query tiles with resets between them, as the rulebook
    groups stream them (tests/test_pallas_merge.py)."""
    rng = np.random.default_rng(1)
    shape = (5, 40, 50)
    nce = 5 * 40 * 52
    zyx, nv = _coords(rng, 1, 1024, shape, [900])
    jk, tk, _ = _tables(zyx, nv, shape)
    act = tco.extended_cells(t(zyx[0, :256]), shape).numpy()
    tiles = []
    for dt in (-1, 0, 1):
        c = np.concatenate([rng.choice(nce, 512),
                            np.clip(act + dt, 0, nce - 1),
                            rng.choice(nce, 256)])
        tiles.append(np.sort(c.astype(np.int32)))
    cells = np.concatenate(tiles)
    want_kernel = jplm.merge_gather(jk.keys[0], jk.coarse[0], jk.shift,
                                    jnp.asarray(cells), interpret=True)
    want_xla = jplm.merge_gather_xla(jk.keys[0], jk.num[0],
                                     jnp.asarray(cells))
    got = merge_cells_plain(tk.keys, tk.num, t(cells)[None, None])[0, 0]
    np.testing.assert_array_equal(n(got), n(want_kernel))
    np.testing.assert_array_equal(n(got), n(want_xla))


@pytest.mark.parametrize("fill", ["random", "full_rows"])
def test_merge_plain_equals_rank_table_on_every_cell(fill):
    """Every cell of the x-extended grid, first and last included, with
    random voxels or with whole x-rows active (runs of adjacent keys)."""
    rng = np.random.default_rng(2)
    shape = (3, 7, 20)
    if fill == "random":
        zyx, nv = _coords(rng, 2, 200, shape, [150, 61])
    else:
        zyx = np.full((2, 200, 3), -1, np.int32)
        rows = [(0, 0), (1, 3), (2, 6)]  # incl. the grid's first and last row
        cells = np.array([(z, y, x) for z, y in rows for x in range(20)])
        zyx[0, :60] = cells
        zyx[1, :20] = cells[20:40]
        nv = np.array([60, 20], np.int32)
    _, tk, tr = _tables(zyx, nv, shape)
    nce = 3 * 7 * 22
    cells = torch.arange(nce, dtype=torch.int32).expand(1, 2, nce)
    want = gather_cells_plain(tr.packed, cells.contiguous())
    got = merge_cells_plain(tk.keys, tk.num, cells.contiguous())
    assert torch.equal(got, want)
    assert int((want & 2).sum()) == 2 * int(nv.sum())  # a0 set on the keys


@pytest.mark.parametrize("builder", ["subm", "strided", "inverse"])
def test_keytable_rulebooks_bit_exact(builder):
    """Rulebooks on KeyTables equal the JAX package's (its XLA merge
    oracle on the CPU) and the port's own on RankTables, at B=2."""
    rng = np.random.default_rng(3)
    shape = (6, 24, 24)
    zyx, nv = _coords(rng, 2, 512, shape, [500, 301])
    V = zyx.shape[1]

    def chain(sp, kind, coords, num):
        s1 = sp.build_structure(coords, num, shape)
        s2 = sp.downsample_structure(s1, 2, capacity=V // 2)
        sp.set_table_kind(kind)
        try:
            t1, t2 = sp.dense_table(s1), sp.dense_table(s2)
        finally:
            sp.set_table_kind("auto")
        if builder == "subm":
            return t1, sp.build_subm_rulebook(s1, table=t1)
        if builder == "strided":
            return t1, sp.build_strided_rulebook(s1, s2, 3, 2, 1, table=t1)
        return t2, sp.build_inverse_rulebook(s2, s1, 3, 2, 1, table=t2)

    jt, want = chain(jsp, "keys", jnp.asarray(zyx), jnp.asarray(nv))
    tt, got = chain(tsp, "keys", t(zyx), t(nv))
    _, got_rank = chain(tsp, "rank", t(zyx), t(nv))
    assert isinstance(jt, jco.KeyTable) and isinstance(tt, tco.KeyTable)
    assert got.dtype == torch.int32 and tuple(got.shape[:2]) == (27, 2)
    np.testing.assert_array_equal(n(got), n(want))
    assert torch.equal(got, got_rank)


@pytest.mark.parametrize("shape", [(21, 256, 256), (41, 1024, 1024),
                                   (21, 512, 512)])
def test_auto_table_kind_matches_jax(shape):
    zyx = np.zeros((1, 8, 3), np.int32)
    nv = np.ones(1, np.int32)
    want = jsp.dense_table(jsp.build_structure(jnp.asarray(zyx),
                                               jnp.asarray(nv), shape))
    got = tsp.dense_table(tsp.build_structure(t(zyx), t(nv), shape))
    assert type(got).__name__ == type(want).__name__
    assert tsp.table_kind(shape) == ("rank" if isinstance(want, jco.RankTable)
                                     else "keys")


def test_coarse_brackets_every_search():
    """The merge kernel searches #{valid keys <= q+1} only between
    coarse[j] and coarse[j+1], j = (q+1) >> shift: that bracket must hold
    the answer for every cell of the grid, at a shift small enough to give
    many blocks (runs of adjacent keys cross block edges)."""
    rng = np.random.default_rng(4)
    shape = (4, 20, 30)
    zyx, nv = _coords(rng, 2, 600, shape, [580, 77])
    zyx[1, :60] = [(1, 2, x) for x in range(30)] + [(1, 3, x)
                                                    for x in range(30)]
    zyx[1, 60:77] = -1
    nv[1] = 60
    nce = 4 * 20 * 32
    for shift in (3, 5, 12):
        tk = tco.build_key_table(t(zyx), t(nv), shape, shift=shift)
        nb = tk.coarse.shape[1] - 1
        qp = torch.arange(1, nce + 1, dtype=torch.int32).repeat(2, 1)
        pos = torch.minimum(torch.searchsorted(tk.keys, qp, right=True),
                            tk.num.to(torch.int64)[:, None])
        j = (qp >> shift).to(torch.int64)
        assert int(j.max()) + 1 <= nb
        assert int(tk.keys[tk.keys != tco.INVALID_KEY].max()) < nb << shift
        assert torch.all(torch.gather(tk.coarse, 1, j) <= pos)
        assert torch.all(pos <= torch.gather(tk.coarse, 1, j + 1))
        assert torch.equal(tk.coarse[:, -1], tk.num)


def test_merge_wrapper_raises_off_cpu_and_cuda():
    keys = torch.zeros(1, 4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        merge_cells(keys, torch.zeros(1, 3, dtype=torch.int32, device="meta"),
                    12, torch.zeros(1, dtype=torch.int32, device="meta"),
                    torch.zeros(1, 1, 4, dtype=torch.int32, device="meta"))
