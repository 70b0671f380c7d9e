"""The host voxelizer and the PointNet++ point operations of the port
against the JAX package's, exactly:

- the C voxelizer (csrc/voxelize.c through core/native_voxelize.py, the
  path of ``points_to_voxel(sort_by_key=True)`` for float32 points) byte
  for byte against the port's numpy path and JAX's ``points_to_voxel``,
  at the published Waymo (0.1 x 0.1 x 0.15 m, 41x1504x1504) and
  SemanticKITTI (0.05 m) grids, with points outside the grid, repeated
  cells, and capacities above, at and below the scan's voxel count;
  other dtypes take the numpy path, and a voxelizer that cannot be built
  raises;
- ``sort_by_key=False`` (the first-occurrence order; past ``max_voxels``
  the earliest-seen voxels stay) against JAX's, and ``SegVoxelization``
  with it in both pipelines' train and val modes;
- ``points_to_voxel`` called without the flag in both packages (the
  first-occurrence order, the default of both), under and over
  ``max_voxels``;
- ``furthest_point_sample``, ``ball_query`` and ``group_points`` against
  JAX's, padded points included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidarseg3d_tpu.core import voxelize as jvox
from lidarseg3d_tpu.ops import pointnet2 as jpn
from lidarseg3d_torch.core import native_voxelize
from lidarseg3d_torch.core import voxelize as tvox
from lidarseg3d_torch.ops import pointnet2 as tpn

GRIDS = {
    "waymo": ([0.1, 0.1, 0.15], [-75.2, -75.2, -2.0, 75.2, 75.2, 4.0]),
    "semkitti": ([0.05, 0.05, 0.05], [0.0, -25.6, -2.0, 51.2, 25.6, 4.4]),
}


def _scan(seed, pcr, n=20000, d=5):
    """Points clustered in a few metres (so cells repeat), some outside
    the grid, float32."""
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(pcr[:3]), np.asarray(pcr[3:])
    centre = lo + (hi - lo) * rng.uniform(0.2, 0.8, 3)
    xyz = centre + rng.normal(0, 1.0, (n, 3))
    xyz[: n // 20] = rng.uniform(lo - 5, hi + 5, (n // 20, 3))
    xyz[n // 20: n // 10] = xyz[n // 10: n // 10 + n // 20]  # repeats
    pts = np.concatenate([xyz, rng.uniform(0, 1, (n, d - 3))], 1)
    return pts.astype(np.float32)


def _same(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_c_voxelizer_is_byte_identical(grid):
    vsz, pcr = GRIDS[grid]
    pts = _scan(1, pcr)
    full = tvox.points_to_voxel_numpy(pts, vsz, pcr, 5, 10 ** 6)
    nv = len(full[0])
    assert nv > 1000
    for cap in (nv + 100, nv, nv // 3):
        c = native_voxelize.points_to_voxel_native(
            pts, vsz, pcr, 5, cap, tvox.compute_grid_size(pcr, vsz))
        _same(c, tvox.points_to_voxel_numpy(pts, vsz, pcr, 5, cap))
        _same(c, tvox.points_to_voxel(pts, vsz, pcr, 5, cap,
                                      sort_by_key=True))
        _same(c, jvox.points_to_voxel(pts, vsz, pcr, 5, cap,
                                      sort_by_key=True))
        assert len(c[0]) == min(cap, nv)
    # float64 points take the numpy path, as in JAX
    p64 = pts.astype(np.float64)
    _same(tvox.points_to_voxel(p64, vsz, pcr, 5, nv // 2, sort_by_key=True),
          jvox.points_to_voxel(p64, vsz, pcr, 5, nv // 2, sort_by_key=True))
    empty = tvox.points_to_voxel(pts[:0], vsz, pcr, 5, 100, sort_by_key=True)
    _same(empty, jvox.points_to_voxel(pts[:0], vsz, pcr, 5, 100,
                                      sort_by_key=True))


def test_c_voxelizer_that_cannot_build_raises(monkeypatch):
    from lidarseg3d_torch.ops import cuda_build

    def fail(*a, **k):
        raise RuntimeError("no C compiler (cc) found")

    monkeypatch.setattr(cuda_build, "load", fail)
    vsz, pcr = GRIDS["waymo"]
    with pytest.raises(RuntimeError, match="C voxelizer"):
        tvox.points_to_voxel(_scan(2, pcr, n=100), vsz, pcr, 5, 10,
                             sort_by_key=True)


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_first_seen_order_matches_jax(grid):
    vsz, pcr = GRIDS[grid]
    pts = _scan(3, pcr)
    nv = len(jvox.points_to_voxel(pts, vsz, pcr, 5, 10 ** 6,
                                  sort_by_key=False)[0])
    for cap in (nv + 1, nv, nv // 4):
        got = tvox.points_to_voxel(pts, vsz, pcr, 5, cap, sort_by_key=False)
        _same(got, jvox.points_to_voxel(pts, vsz, pcr, 5, cap,
                                        sort_by_key=False))
    # the first voxel is the first in-grid point's, not the smallest key
    keys = got[1] @ np.array([10 ** 8, 10 ** 4, 1])
    assert (np.diff(keys) < 0).any()


@pytest.mark.parametrize("over", [False, True])
def test_default_order_matches_jax(over):
    vsz, pcr = GRIDS["semkitti"]
    pts = _scan(7, pcr)
    nv = len(jvox.points_to_voxel(pts, vsz, pcr, 5, 10 ** 6)[0])
    cap = nv // 3 if over else nv + 10
    got = tvox.points_to_voxel(pts, vsz, pcr, 5, cap)
    _same(got, jvox.points_to_voxel(pts, vsz, pcr, 5, cap))
    _same(got, tvox.points_to_voxel(pts, vsz, pcr, 5, cap, sort_by_key=False))
    assert len(got[0]) == min(cap, nv)
    if over:  # the earliest-seen voxels stay, not the smallest keys
        first = tvox.points_to_voxel(pts, vsz, pcr, 5, 10 ** 6)
        np.testing.assert_array_equal(got[1], first[1][:cap])
        keys = tvox.points_to_voxel(pts, vsz, pcr, 5, cap, sort_by_key=True)
        assert set(map(tuple, got[1])) != set(map(tuple, keys[1]))


@pytest.mark.parametrize("mode", ["train", "val"])
def test_seg_voxelization_without_key_order_matches_jax(mode):
    from lidarseg3d_tpu.datasets.pipelines.seg_preprocess import (
        SegVoxelization as JSegVox)
    from lidarseg3d_torch.datasets.pipelines.seg_preprocess import (
        SegVoxelization as TSegVox)

    vsz, pcr = GRIDS["semkitti"]
    cfg = dict(range=pcr, voxel_size=vsz, max_points_in_voxel=5,
               max_voxel_num=[3000, 2500], sort_by_key=False)
    pts = _scan(4, pcr, d=4)
    lab = np.concatenate([pts, np.random.default_rng(5).integers(
        1, 20, (len(pts), 1)).astype(np.float32)], 1)
    outs = []
    for cls in (JSegVox, TSegVox):
        sample = {"mode": mode, "points": pts.copy(),
                  "points_with_labels": lab.copy()}
        outs.append(cls(cfg=dict(cfg))(sample, {})[0]["voxels"])
    assert set(outs[0]) == set(outs[1])
    for k in outs[0]:
        a, b = np.asarray(outs[0][k]), np.asarray(outs[1][k])
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k
    assert len(outs[1]["voxels"]) == (3000 if mode == "train" else 2500)


def test_pointnet2_ops_match_jax():
    rng = np.random.default_rng(6)
    xyz = rng.uniform(-1, 1, (400, 3)).astype(np.float32)
    valid = rng.uniform(size=400) > 0.25
    valid[:4] = False  # the first valid point is not the first point
    xyz[~valid] = 0.0  # padded rows sit on the origin, inside every ball
    want = np.asarray(jpn.furthest_point_sample(
        jnp.asarray(xyz), jnp.asarray(valid), 64))
    got = tpn.furthest_point_sample(torch.from_numpy(xyz),
                                    torch.from_numpy(valid), 64)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[0] == int(np.argmax(valid)) > 3 and valid[want].all()
    centers = xyz[want[:30]].copy()
    centers[-2] = (9.0, 9.0, 9.0)  # no point in its ball
    centers[-1] = (0.0, 0.0, 0.0)  # next to the padded rows
    full = []
    for radius, ns in ((0.2, 4), (0.5, 16)):
        ji, jc = jpn.ball_query(jnp.asarray(centers), jnp.asarray(xyz),
                                jnp.asarray(valid), radius, ns)
        ti, tc = tpn.ball_query(torch.from_numpy(centers),
                                torch.from_numpy(xyz),
                                torch.from_numpy(valid), radius, ns)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        assert tc[-2] == 0 and (ti[-2] == 0).all()
        assert valid[ti.numpy()[tc.numpy() > 0]].all()
        feats = rng.normal(size=(400, 7)).astype(np.float32)
        np.testing.assert_array_equal(
            tpn.group_points(torch.from_numpy(feats), ti).numpy(),
            np.asarray(jpn.group_points(jnp.asarray(feats), ji)))
        full.append((tc.numpy() == ns).any())
    assert any(full) and (tc.numpy() < ns).any()
