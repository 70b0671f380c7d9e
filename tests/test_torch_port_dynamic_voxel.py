"""lidarseg3d_torch's dynamic voxelization, single-cell lookups and
Cylinder3D's rulebooks against the JAX package (CPU, plain versions of the
kernels):

- exactly: ``unique_coords``' structure and ``assign_points_to_voxels``'
  structure, p2v and found (every position) on both table kinds, with
  invalid points and a capacity overflow; ``lookup_key`` /
  ``lookup_coords`` on KeyTables and RankTables, queries outside every
  face and masked ones included (the row at every position: a miss's row
  is the JAX package's searchsorted position); every rulebook of a
  Cylinder3D stack on both kinds: subm at (1,3,3), (3,1,3) (K = 9),
  (3,3,3), (1,1,3) (K = 3) and the x-width-1 (3,1,1), (1,3,1), strided and
  inverse at strides (2,2,2) and (2,2,1); the voted voxel labels;
- within 1e-5 of the largest reference entry: segment sum, mean and max,
  cart2cylind; the metric binning exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidarseg3d_tpu.ops import coords as jco
from lidarseg3d_tpu.ops import dynamic_voxel as jdv
from lidarseg3d_tpu.ops import sparse as jsp
from lidarseg3d_torch.ops import coords as tco
from lidarseg3d_torch.ops import dynamic_voxel as tdv
from lidarseg3d_torch.ops import sparse as tsp

from _torch_port_helpers import assert_close_rel, n, t

GRID = (24, 20, 8)  # (R, P, Z) as Cylinder3D's (z, y, x) structure axes
REL = 1e-5


@pytest.fixture(params=["rank", "keys"])
def kind(request):
    jsp.set_table_kind(request.param)
    tsp.set_table_kind(request.param)
    try:
        yield request.param
    finally:
        jsp.set_table_kind("auto")
        tsp.set_table_kind("auto")


def points(seed, B=2, N=900, grid=GRID):
    rng = np.random.default_rng(seed)
    c = np.stack([rng.integers(0, g, (B, N)) for g in grid], -1)
    # clustered duplicates, as points of one voxel
    c[:, N // 2:] = c[:, :N - N // 2]
    valid = rng.random((B, N)) > 0.15
    valid[1, N - 200:] = False
    return c.astype(np.int32), valid


def assign(coords, valid, cap):
    js, jp, jf = jdv.assign_points_to_voxels(jnp.asarray(coords),
                                             jnp.asarray(valid), GRID, cap)
    ts, tp, tf = tdv.assign_points_to_voxels(t(coords), t(valid), GRID, cap)
    return (js, jp, jf), (ts, tp, tf)


@pytest.mark.parametrize("cap", [700, 300])
def test_assign_points_to_voxels_matches_jax(kind, cap):
    coords, valid = points(0)
    (js, jp, jf), (ts, tp, tf) = assign(coords, valid, cap)
    np.testing.assert_array_equal(n(ts.coords), n(js.coords))
    np.testing.assert_array_equal(n(ts.num_voxels), n(js.num_voxels))
    assert ts.spatial_shape == js.spatial_shape
    np.testing.assert_array_equal(n(tp), n(jp))
    np.testing.assert_array_equal(n(tf), n(jf))
    assert n(tf).sum() > 500
    if cap == 300:  # overflow: the largest keys drop, their points miss
        assert (n(ts.num_voxels) == cap).all() and (n(tf) < valid).any()
    else:
        np.testing.assert_array_equal(n(tf), valid)


def test_unique_coords_matches_jax():
    coords, valid = points(1)
    jc, jn, jk = jco.unique_coords(jnp.asarray(coords), jnp.asarray(valid),
                                   GRID, 500)
    tc, tn, tk = tsp.unique_coords(t(coords), t(valid), GRID, 500)
    for a, b in ((tc, jc), (tn, jn), (tk, jk)):
        np.testing.assert_array_equal(n(a), n(b))


def queries(rng, B, Q, grid):
    q = np.stack([rng.integers(-2, g + 2, (B, Q)) for g in grid], -1)
    q[:, :8] = [[-1, 0, 0], [0, -1, 0], [0, 0, -1], [grid[0], 0, 0],
                [0, grid[1], 0], [0, 0, grid[2]], [0, 0, 0],
                [g - 1 for g in grid]]
    return q.astype(np.int32), rng.random((B, Q)) > 0.2


@pytest.mark.parametrize("full", [False, True])
def test_lookups_match_jax(kind, full):
    """lookup_key / lookup_rank through lookup_coords; ``full``: a 1024-row
    structure at capacity, so a query past its last key hits the clip at
    the JAX package's padded key count."""
    rng = np.random.default_rng(2)
    cap = 1024 if full else 700
    c, v = points(3, N=3000 if full else 900)
    js, _, _ = jdv.assign_points_to_voxels(jnp.asarray(c), jnp.asarray(v),
                                           GRID, cap)
    ts = tsp.build_structure(t(np.asarray(js.coords)),
                             t(np.asarray(js.num_voxels)), GRID)
    if full:
        assert (n(ts.num_voxels) == cap).all()
    jt, tt = jsp.dense_table(js), tsp.dense_table(ts)
    want_kind = {"rank": tco.RankTable, "keys": tco.KeyTable}[kind]
    assert isinstance(tt, want_kind)
    q, ev = queries(rng, 2, 2000, GRID)
    q[:, 8] = [g - 1 for g in GRID]  # past every key of the last row
    for extra in (None, ev):
        ji, jf = jco.lookup_coords(jt, jnp.asarray(q), GRID,
                                   None if extra is None
                                   else jnp.asarray(extra))
        ti, tf = tco.lookup_coords(tt, t(q), GRID,
                                   None if extra is None else t(extra))
        np.testing.assert_array_equal(n(tf), n(jf))
        np.testing.assert_array_equal(n(ti), n(ji))
        assert n(tf).sum() > 50


def _stack(kind):
    """A Cylinder3D-like stack: s1 from points, s2 = s1 / (2,2,2), s3 =
    s2 / (2,2,1), on both packages."""
    c, v = points(4, N=1200)
    js1, _, _ = jdv.assign_points_to_voxels(jnp.asarray(c), jnp.asarray(v),
                                            GRID, 800)
    ts1 = tsp.build_structure(t(np.asarray(js1.coords)),
                              t(np.asarray(js1.num_voxels)), GRID)
    js, ts = [js1], [ts1]
    for stride, capr in (((2, 2, 2), 0.6), ((2, 2, 1), 0.4)):
        cap = max(1, int(800 * capr))
        js.append(jsp.downsample_structure(js[-1], stride, cap))
        ts.append(tsp.downsample_structure(ts[-1], stride, cap))
        np.testing.assert_array_equal(n(ts[-1].coords), n(js[-1].coords))
    return js, ts


KERNELS = [(1, 3, 3), (3, 1, 3), (3, 3, 3), (1, 1, 3), (3, 1, 1), (1, 3, 1)]


def _books(sp, ss, tabs):
    """Every rulebook of the stack, by name, through package ``sp``."""
    out = {}
    for i, s in enumerate(ss):
        for ks in KERNELS:
            out[f"s{i} {ks}"] = sp.build_subm_rulebook(s, ks, table=tabs[i])
    for i, stride in ((0, (2, 2, 2)), (1, (2, 2, 1))):
        out[f"strided {stride}"] = sp.build_strided_rulebook(
            ss[i], ss[i + 1], 3, stride, 1, table=tabs[i])
        out[f"inverse {stride}"] = sp.build_inverse_rulebook(
            ss[i + 1], ss[i], 3, stride, 1, table=tabs[i + 1])
    return out


def test_cylinder3d_rulebooks_match_jax(kind):
    js, ts = _stack(kind)
    # one compiled program for the JAX side (its eager builds are slow)
    want = jax.jit(lambda ss: _books(jsp, ss, [jsp.dense_table(s)
                                                for s in ss]))(js)
    got = _books(tsp, ts, [tsp.dense_table(s) for s in ts])
    assert set(got) == set(want)
    for name, rb in got.items():
        if name[1].isdigit():  # a subm rulebook "s{i} (kz, ky, kx)"
            ks = eval(name.split(" ", 1)[1])
            assert rb.shape[0] == int(np.prod(ks)), name
        np.testing.assert_array_equal(n(rb), n(want[name]), name)
    for stride in ((2, 2, 2), (2, 2, 1)):
        rb = got[f"inverse {stride}"]
        assert (n(rb) < rb.shape[1] * ts[1].capacity).sum() > 100


def test_width_one_needs_a_width_of_one_or_three():
    _, ts = _stack("auto")
    with pytest.raises(NotImplementedError, match="x width 5"):
        tsp.build_subm_rulebook(ts[0], (1, 1, 5))


def test_segment_ops_and_label_vote_match_jax():
    coords, valid = points(5)
    (_, jp, jf), (_, tp, tf) = assign(coords, valid, 700)
    rng = np.random.default_rng(6)
    vals = rng.standard_normal(coords.shape[:2] + (5,)).astype(np.float32)
    for name in ("segment_sum", "segment_mean", "segment_max"):
        want = getattr(jdv, name)(jnp.asarray(vals), jp, jf, 700)
        got = getattr(tdv, name)(t(vals), tp, tf, 700)
        assert_close_rel(got, want, REL, name)
    labels = rng.integers(0, 6, coords.shape[:2]).astype(np.int32)
    np.testing.assert_array_equal(
        n(tdv.segment_label_vote(t(labels), tp, tf, 700, 6)),
        n(jdv.segment_label_vote(jnp.asarray(labels), jp, jf, 700, 6)))


def test_cylindrical_coordinates_match_jax():
    rng = np.random.default_rng(7)
    p = rng.uniform(-40, 40, (2, 500, 3)).astype(np.float32)
    assert_close_rel(tdv.cart2cylind(t(p)), jdv.cart2cylind(jnp.asarray(p)),
                     REL, "cart2cylind")
    lo, hi, gs = (-40.0, -40.0, -4.0), (40.0, 40.0, 4.0), (16, 16, 8)
    jc, jin = jdv.grid_coords_from_metric(jnp.asarray(p), lo, hi, gs)
    tc, tin = tdv.grid_coords_from_metric(t(p), lo, hi, gs)
    np.testing.assert_array_equal(n(tc), n(jc))
    np.testing.assert_array_equal(n(tin), n(jin))
    assert 0 < n(tin).sum() < tin.numel()
