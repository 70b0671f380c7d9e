"""Host-side hard voxelization (numpy), own copy of the key-sorted path of
lidarseg3d_tpu/core/voxelize.py.

Only the production path is kept: ``sort_by_key=True``, voxels come out in
ascending linear (z, y, x) key order, which the rank tables of ops/coords.py
require (row index == rank - 1). The JAX package serves the same path with
a C voxelizer when it is built; the numpy code here is its byte-identical
semantic reference and takes tens of milliseconds per scan at the bench
shape.
"""

import numpy as np


def compute_grid_size(point_cloud_range, voxel_size):
    pc_range = np.asarray(point_cloud_range, dtype=np.float32)
    vsize = np.asarray(voxel_size, dtype=np.float32)
    return np.round((pc_range[3:] - pc_range[:3]) / vsize).astype(np.int64)


def points_to_voxel(points, voxel_size, coors_range, max_points=35,
                    max_voxels=20000):
    """Hard-voxelize a point cloud into key-sorted voxels.

    Returns voxels [M, max_points, D] (zero padded), coors [M, 3] int32 in
    (z, y, x) order and num_points_per_voxel [M] int32. When the scan holds
    more than ``max_voxels`` voxels, the smallest keys are kept.
    """
    points = np.asarray(points)
    voxel_size = np.asarray(voxel_size, dtype=np.float32)
    coors_range = np.asarray(coors_range, dtype=np.float32)
    grid_size = compute_grid_size(coors_range, voxel_size)  # xyz

    c = np.floor((points[:, :3] - coors_range[:3]) / voxel_size).astype(
        np.int64)
    in_range = np.all((c >= 0) & (c < grid_size[None, :]), axis=1)
    pidx = np.nonzero(in_range)[0]
    c = c[pidx]
    if len(pidx) == 0:
        return (np.zeros((0, max_points, points.shape[1]), points.dtype),
                np.zeros((0, 3), np.int32), np.zeros((0,), np.int32))

    key = (c[:, 2] * grid_size[1] + c[:, 1]) * grid_size[0] + c[:, 0]
    sort_idx = np.argsort(key, kind="stable")
    skey = key[sort_idx]
    n = len(skey)
    new = np.empty(n, dtype=bool)
    new[0] = True
    np.not_equal(skey[1:], skey[:-1], out=new[1:])
    vox_sorted = np.cumsum(new) - 1
    starts = np.nonzero(new)[0]
    num_vox = min(len(starts), max_voxels)
    rank_sorted = np.arange(n) - starts[vox_sorted]
    keep = (vox_sorted < num_vox) & (rank_sorted < max_points)
    voxels = np.zeros((num_vox, max_points, points.shape[1]),
                      dtype=points.dtype)
    voxels[vox_sorted[keep], rank_sorted[keep]] = points[pidx[sort_idx[keep]]]
    counts = np.diff(np.append(starts, n))
    num_points_per_voxel = np.minimum(counts[:num_vox], max_points).astype(
        np.int32)
    kept_keys = skey[starts[:num_vox]]
    cz = kept_keys // (grid_size[1] * grid_size[0])
    rem = kept_keys % (grid_size[1] * grid_size[0])
    coors = np.stack([cz, rem // grid_size[0], rem % grid_size[0]],
                     axis=1).astype(np.int32)
    return voxels, coors, num_points_per_voxel


class VoxelGenerator:
    """API of the JAX package's VoxelGenerator, key-sorted output."""

    def __init__(self, voxel_size, point_cloud_range, max_num_points,
                 max_voxels=20000):
        self._voxel_size = np.array(voxel_size, dtype=np.float32)
        self._point_cloud_range = np.array(point_cloud_range,
                                           dtype=np.float32)
        self._max_num_points = max_num_points
        self._max_voxels = max_voxels
        self._grid_size = compute_grid_size(point_cloud_range, voxel_size)

    def generate(self, points, max_voxels=-1):
        if max_voxels == -1:
            max_voxels = self._max_voxels
        return points_to_voxel(points, self._voxel_size,
                               self._point_cloud_range,
                               self._max_num_points, max_voxels)

    @property
    def voxel_size(self):
        return self._voxel_size

    @property
    def max_num_points_per_voxel(self):
        return self._max_num_points

    @property
    def point_cloud_range(self):
        return self._point_cloud_range

    @property
    def grid_size(self):
        return self._grid_size
