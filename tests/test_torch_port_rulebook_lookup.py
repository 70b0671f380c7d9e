"""The rank-table rulebook lookups of lidarseg3d_torch (the plain twins of
csrc/rank_lookup.cu's fused rulebook build, its KeyTable front end and
decode, and its single-cell mode) against the JAX package, bit for bit:
subm, strided and inverse rulebooks on RankTables and KeyTables at B=2
with ragged voxel counts and voxels on every face of the grid, and
coords.lookup_rank with queries outside the grid. The kernels run only on
the card (chip_smoke.py phase 4 holds them against these twins)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lidarseg3d_tpu.ops import coords as jco
from lidarseg3d_tpu.ops import sparse as jsp
from lidarseg3d_torch.ops import coords as tco
from lidarseg3d_torch.ops import rank_lookup as rl
from lidarseg3d_torch.ops import sparse as tsp
from lidarseg3d_torch.ops.merge_lookup import merge_cells_plain

from _torch_port_helpers import n, t

SHAPE = (6, 14, 18)
V = 700


def _edge_coords(seed, nvox=(640, 233)):
    """B=2 key-sorted voxel sets, -1 padded to V rows, each holding voxels
    on all six faces of the grid (z = 0, Z-1; y = 0, Y-1; x = 0, X-1) and
    its corners."""
    rng = np.random.default_rng(seed)
    Z, Y, X = SHAPE
    zyx = np.full((2, V, 3), -1, np.int32)
    nv = np.zeros(2, np.int32)
    for b, want in enumerate(nvox):
        faces = np.concatenate([
            rng.integers(0, Y * X, 12),                      # z = 0
            (Z - 1) * Y * X + rng.integers(0, Y * X, 12),    # z = Z-1
            rng.integers(0, Z, 12) * Y * X + rng.integers(0, X, 12),  # y = 0
            rng.integers(0, Z, 12) * Y * X + (Y - 1) * X
            + rng.integers(0, X, 12),                        # y = Y-1
            (rng.integers(0, Z * Y, 12)) * X,                # x = 0
            (rng.integers(0, Z * Y, 12)) * X + X - 1,        # x = X-1
            [0, X - 1, Z * Y * X - 1, Z * Y * X - X]])       # corners
        faces = np.unique(faces)
        others = np.setdiff1d(np.arange(Z * Y * X), faces)
        keys = np.sort(np.concatenate([faces, rng.choice(
            others, want - len(faces), replace=False)]))
        nv[b] = len(keys)
        zyx[b, :nv[b]] = np.stack([keys // (Y * X), (keys // X) % Y,
                                   keys % X], -1)
    return zyx, nv


# (builder, stride, padding): the main path's (subm; strided and inverse at
# padding 1 and stage 4's (0, 1, 1)) and the inverse with sx = 1
CASES = [("subm", 1, 1), ("strided", 2, 1), ("strided", 2, (0, 1, 1)),
         ("inverse", 2, 1), ("inverse", 2, (0, 1, 1)),
         ("inverse", (2, 2, 1), 1)]


def _build(sp, kind, zyx, nv, builder, stride, pad):
    """The rulebook of one case through the package ``sp``."""
    s1 = sp.build_structure(zyx, nv, SHAPE)
    sp.set_table_kind(kind)
    try:
        if builder == "subm":
            return sp.build_subm_rulebook(s1, table=sp.dense_table(s1))
        s2 = sp.downsample_structure(s1, stride, capacity=V // 2,
                                     padding=pad)
        t1, t2 = sp.dense_table(s1), sp.dense_table(s2)
    finally:
        sp.set_table_kind("auto")
    if builder == "strided":
        return sp.build_strided_rulebook(s1, s2, 3, stride, pad, table=t1)
    return sp.build_inverse_rulebook(s2, s1, 3, stride, pad, table=t2)


@pytest.mark.parametrize("builder,stride,pad", CASES)
def test_rulebooks_match_jax(builder, stride, pad):
    """Both table kinds: the port's rulebook (the plain twins, CPU) equals
    the JAX package's on the same table kind, and the two kinds agree."""
    zyx, nv = _edge_coords(0)
    got = {}
    for kind in ("rank", "keys"):
        want = _build(jsp, kind, jnp.asarray(zyx), jnp.asarray(nv),
                         builder, stride, pad)
        got[kind] = _build(tsp, kind, t(zyx), t(nv), builder, stride,
                           pad)
        assert got[kind].dtype == torch.int32
        np.testing.assert_array_equal(n(got[kind]), n(want),
                                      err_msg=f"{builder} {kind}")
    assert torch.equal(got["rank"], got["keys"])
    # the rulebook reaches every face: hits and misses both occur
    rb = got["rank"]
    miss = rb.shape[1] * (V if builder != "inverse" else V // 2)
    assert bool((rb == miss).any()) and bool((rb != miss).any())


def _specs(s1, s2, t1, t2):
    """(query structure, table, spec) of a subm, strided and inverse
    rulebook between s1 and its downsample s2."""
    return [(s1, t1, tsp.subm_spec(t1, s1)),
            (s2, t1, tsp.strided_spec(t1, s1, 3, 2, (0, 1, 1))),
            (s1, t2, tsp.inverse_spec(t2, s2, 3, 2, 1))]


def test_front_end_cells_give_the_clamped_rulebooks():
    """On a KeyTable the front end hands the merge each query's cell with
    its coordinates clamped into the grid and leaves out kernel_cells'
    per-row clamp: masked queries may read any in-range cell. The
    rulebooks from the front end's cells, from kernel_cells' clamped cells
    and from random in-range cells at every masked query are the same."""
    zyx, nv = _edge_coords(1)
    rng = np.random.default_rng(2)
    s1 = tsp.build_structure(t(zyx), t(nv), SHAPE)
    s2 = tsp.downsample_structure(s1, 2, capacity=V // 2, padding=(0, 1, 1))
    k1 = tco.build_key_table(s1.coords, s1.num_voxels, SHAPE)
    k2 = tco.build_key_table(s2.coords, s2.num_voxels, s2.spatial_shape)
    for s, kt, spec in _specs(s1, s2, k1, k2):
        cells, inb, _ = rl.rulebook_queries(s.coords, s.num_voxels, spec)
        assert torch.equal(cells, rl.rulebook_cells(s.coords, s.num_voxels,
                                                    spec))
        assert int(cells.min()) >= 0 and int(cells.max()) < spec.nce
        assert bool((~inb).any())
        noise = t(rng.integers(0, spec.nce, cells.shape).astype(np.int32))
        rbs = [rl.rulebook_decode(merge_cells_plain(kt.keys, kt.num, c),
                                  s.coords, s.num_voxels, spec)
               for c in (cells, tsp.kernel_cells(kt, cells, inb),
                         torch.where(inb, cells, noise))]
        assert torch.equal(rbs[0], rbs[1]) and torch.equal(rbs[0], rbs[2])
        assert torch.equal(rbs[0], tsp.build_rulebook(kt, s, spec))


def test_devoxelization_keeps_the_clamp():
    """The sorted devoxelization reads the own cell's rank at every query
    (out-of-grid ones too), so it keeps kernel_cells' clamp: its grouped
    lookup on a KeyTable equals the JAX package's at every position."""
    zyx, nv = _edge_coords(4)
    rng = np.random.default_rng(5)
    Z, Y, X = SHAPE
    jk = jco.build_key_table(jnp.asarray(zyx), jnp.asarray(nv), SHAPE)
    tk = tco.build_key_table(t(zyx), t(nv), SHAPE)
    cell = rng.integers(-40, Z * Y * (X + 2) + 40, (9, 2, 300)).astype(
        np.int32)
    cell.sort(axis=-1)
    inb = (cell >= 0) & (cell < Z * Y * (X + 2)) & (rng.random(cell.shape)
                                                    < 0.8)
    want = jsp.lookup_rank3_cells(jk, jnp.asarray(cell), jnp.asarray(inb))
    got = tsp.lookup_rank3_cells(tk, t(cell), t(inb))
    for (wi, wf), (gi, gf) in zip(want, got):
        np.testing.assert_array_equal(n(gf), n(wf))
        np.testing.assert_array_equal(n(gi), n(wi))


@pytest.mark.parametrize("extra", [False, True])
def test_lookup_single_matches_jax(extra):
    """coords.lookup_rank (the single-cell mode) at B=2 with queries on
    and far outside every face of the grid: row and found equal the JAX
    package's at every position (the devoxelization's fallback reads the
    row of points that were not found)."""
    zyx, nv = _edge_coords(6)
    rng = np.random.default_rng(7)
    Z, Y, X = SHAPE
    q = np.stack([rng.integers(-30, Z + 30, (2, 3000)),
                  rng.integers(-3, Y + 3, (2, 3000)),
                  rng.integers(-3, X + 3, (2, 3000))], -1).astype(np.int32)
    q[:, :V] = np.where(zyx >= 0, zyx, q[:, :V])  # the voxels' own cells
    ev = rng.random((2, 3000)) < 0.9 if extra else None
    jt = jco.build_rank_table(jnp.asarray(zyx), jnp.asarray(nv), SHAPE)
    tt = tco.build_rank_table(t(zyx), t(nv), SHAPE)
    wi, wf = jco.lookup_rank(jt, jnp.asarray(q),
                             None if ev is None else jnp.asarray(ev))
    gi, gf = tco.lookup_rank(tt, t(q), None if ev is None else t(ev))
    assert gi.dtype == torch.int32 and gf.dtype == torch.bool
    np.testing.assert_array_equal(n(gf), n(wf))
    np.testing.assert_array_equal(n(gi), n(wi))
    assert 0 < int(gf.sum()) < gf.numel()


def test_wrappers_raise_on_other_devices_and_dtypes():
    """Each wrapper launches a kernel or raises: a tensor that is neither
    on the CPU nor on a CUDA device, an int64 or a non-contiguous tensor
    is refused, never handed to the plain twin."""
    spec = rl.RulebookSpec(False, 3, 3, (1, 1, 1), (1, 1, 1), (2, 3, 4), 8)
    G, nce = spec.groups, spec.nce

    def i32(*shape, device="cpu"):
        return torch.zeros(*shape, dtype=torch.int32, device=device)

    calls = {
        "meta": lambda: rl.rulebook_rank(i32(1, nce, device="meta"),
                                         i32(1, 8, 3, device="meta"),
                                         i32(1, device="meta"), spec),
        "int64": lambda: rl.rulebook_cells(i32(1, 8, 3).long(), i32(1),
                                           spec),
        "strided": lambda: rl.rulebook_decode(i32(G, 1, 16)[..., ::2],
                                              i32(1, 8, 3), i32(1), spec),
        "table shape": lambda: rl.rulebook_rank(i32(1, nce + 1),
                                                i32(1, 8, 3), i32(1), spec),
        "single meta": lambda: rl.lookup_single(
            i32(1, nce, device="meta"), spec.grid,
            i32(1, 5, 3, device="meta")),
        "single extra dtype": lambda: rl.lookup_single(
            i32(1, nce), spec.grid, i32(1, 5, 3), i32(1, 5)),
        "gather meta": lambda: rl.gather_cells(i32(1, nce, device="meta"),
                                               i32(1, 1, 4, device="meta")),
    }
    for what, call in calls.items():
        with pytest.raises(ValueError):
            call()
            pytest.fail(what)
