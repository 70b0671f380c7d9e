"""lidarseg3d_torch's sorted devoxelization (_grid_interp_sorted, reached
through grid_three_interpolate without a subm rulebook) against the JAX
package's, on a KeyTable (the merge lookup) and on a RankTable.

The points include valid points one cell and several cells outside the
grid on every side, and thirty points in one cell. Points outside the grid
read the raw rank of their own (clipped) cell for the rank-order fallback,
so on a KeyTable they test the per-row clamp of the query cells that the
JAX package's _merge_cells applies.

Tolerance: fp32, max |err| <= 1e-5 * max |reference|."""

import numpy as np
import jax.numpy as jnp
import pytest

from lidarseg3d_tpu.ops import coords as jco
from lidarseg3d_tpu.ops import interpolate as jinterp
from lidarseg3d_tpu.ops import sparse as jsp
from lidarseg3d_torch.ops import coords as tco
from lidarseg3d_torch.ops import interpolate as tinterp
from lidarseg3d_torch.ops import sparse as tsp

from _torch_port_helpers import assert_close_rel, t

SHAPE = (6, 24, 24)  # (Z, Y, X)
VSZ = (0.1, 0.1, 0.1)
PCR = (0.0, 0.0, 0.0, 2.4, 2.4, 0.6)
B, V, N, C = 2, 400, 700, 8


def _scene():
    rng = np.random.default_rng(11)
    Z, Y, X = SHAPE
    zyx = np.full((B, V, 3), -1, np.int32)
    nv = np.array([380, 150], np.int32)
    for b in range(B):
        keys = np.sort(rng.choice(Z * Y * X, nv[b], replace=False))
        zyx[b, :nv[b]] = np.stack([keys // (Y * X), (keys // X) % Y,
                                   keys % X], -1)
    hi = np.array(PCR[3:])
    pts = rng.uniform(0, 1, (B, N, 3)) * hi
    # one cell outside each face, then several cells outside (x, y, z)
    edge = []
    for ax in range(3):
        for off in (-0.5, 0.5 + 1, -3.5, 3.5 + 1):
            p = rng.uniform(0, 1, 3) * hi
            p[ax] = (off if off < 0 else hi[ax] / VSZ[ax] + off - 1) * VSZ[ax]
            edge.append(p)
    pts[:, :len(edge)] = np.array(edge)
    pts[:, 40:70] = (np.array([7, 9, 2]) + rng.uniform(0.1, 0.9, (30, 3))
                     ) * np.array(VSZ)  # thirty points in one cell
    valid = rng.random((B, N)) < 0.95
    valid[:, :70] = True
    feats = rng.normal(size=(B, V, C)).astype(np.float32)
    return zyx, nv, pts.astype(np.float32), valid, feats


@pytest.mark.parametrize("kind", ["keys", "rank"])
def test_sorted_interp_matches_jax(kind):
    zyx, nv, pts, valid, feats = _scene()
    js = jsp.build_structure(jnp.asarray(zyx), jnp.asarray(nv), SHAPE)
    ts = tsp.build_structure(t(zyx), t(nv), SHAPE)
    if kind == "keys":
        jt = jco.build_key_table(js.coords, js.num_voxels, SHAPE)
    else:
        jt = jco.build_rank_table(js.coords, js.num_voxels, SHAPE)
    tsp.set_table_kind(kind)
    try:
        tt = tsp.dense_table(ts)
    finally:
        tsp.set_table_kind("auto")
    assert type(tt).__name__ == type(jt).__name__
    want = jinterp.grid_three_interpolate(
        jnp.asarray(pts), jnp.asarray(valid), js, jnp.asarray(feats), VSZ,
        PCR, table=jt)
    got = tinterp.grid_three_interpolate(t(pts), t(valid), ts, t(feats),
                                         VSZ, PCR, table=tt)
    assert_close_rel(got, want, 1e-5, f"sorted interp on {kind}")
    # the out-of-grid points were valid and took the fallback
    pv = tinterp._point_voxel_coords(t(pts), VSZ, PCR)
    outside = ~((pv >= 0) & (pv < t(np.array(SHAPE, np.int32)))).all(-1)
    assert int((outside & t(valid)).sum()) >= 2 * 12
    assert float(got[:, :12].abs().sum()) > 0


def test_keytable_rank_clamp_decides_fallback():
    """Without the clamp, points several cells beyond the grid's high faces
    would read the rank of the last grid cell (every key) instead of the
    rank at the row's largest in-grid query: the two differ here, so the
    equality above depends on the clamp."""
    zyx, nv, pts, valid, _ = _scene()
    ts = tsp.build_structure(t(zyx), t(nv), SHAPE)
    kt = tco.build_key_table(ts.coords, ts.num_voxels, SHAPE)
    Z, Y, X = SHAPE
    cell = t(np.full((1, B, 4), Z * Y * (X + 2) + 50, np.int32))
    inb = t(np.array([[[True, False, False, False]] * B]))
    cell[0, :, 0] = 5
    clamped = tsp.kernel_cells(kt, cell, inb)
    assert clamped.max() == 5
    (_, _), (i0, _), (_, _) = tsp.lookup_rank3_cells(kt, cell, inb)
    assert int(i0[0, 0, 3]) < int(nv[0]) - 1
