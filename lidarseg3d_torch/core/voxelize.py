"""Host-side hard voxelization, own copy of lidarseg3d_tpu/core/voxelize.py.

The production path, ``sort_by_key=True`` (``VoxelGenerator``'s
default), gives voxels in ascending
linear (z, y, x) key order, which the rank tables of ops/coords.py require
(row index == rank - 1); for float32 points it runs in C
(core/native_voxelize.py, csrc/voxelize.c), byte-identical to the numpy
code here (``points_to_voxel_numpy``), which stays its reference and
serves other inputs. ``sort_by_key=False``, the default of
``points_to_voxel`` as in the reference, is its first-occurrence order
(numpy): voxels in the order the scan first
reaches them, and past ``max_voxels`` the earliest-seen voxels are kept.
"""

import numpy as np

from . import native_voxelize


def compute_grid_size(point_cloud_range, voxel_size):
    pc_range = np.asarray(point_cloud_range, dtype=np.float32)
    vsize = np.asarray(voxel_size, dtype=np.float32)
    return np.round((pc_range[3:] - pc_range[:3]) / vsize).astype(np.int64)


def points_to_voxel(points, voxel_size, coors_range, max_points=35,
                    max_voxels=20000, sort_by_key=False):
    """Hard-voxelize a point cloud.

    Returns voxels [M, max_points, D] (zero padded; a voxel's first
    ``max_points`` points in scan order), coors [M, 3] int32 in (z, y, x)
    order and num_points_per_voxel [M] int32. With ``sort_by_key`` the
    voxels are in key order and past ``max_voxels`` the smallest keys are
    kept (in C for float32 points); without it they are in the order the
    scan first reaches them and the earliest-seen are kept.
    """
    points = np.asarray(points)
    if not sort_by_key:
        return _points_to_voxel_first_seen(points, voxel_size, coors_range,
                                           max_points, max_voxels)
    grid_size = compute_grid_size(coors_range, voxel_size)
    if native_voxelize.serves(points, grid_size):
        return native_voxelize.points_to_voxel_native(
            points, voxel_size, coors_range, max_points, max_voxels,
            grid_size)
    return points_to_voxel_numpy(points, voxel_size, coors_range,
                                 max_points, max_voxels)


def _cells(points, voxel_size, coors_range):
    """-> (grid size (x, y, z), indices of the points inside the grid,
    their linear (z, y, x) keys)."""
    voxel_size = np.asarray(voxel_size, dtype=np.float32)
    coors_range = np.asarray(coors_range, dtype=np.float32)
    grid_size = compute_grid_size(coors_range, voxel_size)  # xyz
    c = np.floor((points[:, :3] - coors_range[:3]) / voxel_size).astype(
        np.int64)
    in_range = np.all((c >= 0) & (c < grid_size[None, :]), axis=1)
    pidx = np.nonzero(in_range)[0]
    c = c[pidx]
    key = (c[:, 2] * grid_size[1] + c[:, 1]) * grid_size[0] + c[:, 0]
    return grid_size, pidx, key


def _empty(points, max_points):
    return (np.zeros((0, max_points, points.shape[1]), points.dtype),
            np.zeros((0, 3), np.int32), np.zeros((0,), np.int32))


def _coors(keys, grid_size):
    cz = keys // (grid_size[1] * grid_size[0])
    rem = keys % (grid_size[1] * grid_size[0])
    return np.stack([cz, rem // grid_size[0], rem % grid_size[0]],
                    axis=1).astype(np.int32)


def _points_to_voxel_first_seen(points, voxel_size, coors_range, max_points,
                                max_voxels):
    """The reference's order: voxels by their first point in the scan."""
    grid_size, pidx, key = _cells(points, voxel_size, coors_range)
    if len(pidx) == 0:
        return _empty(points, max_points)
    uniq, first_idx, inv, counts = np.unique(
        key, return_index=True, return_inverse=True, return_counts=True)
    occ_order = np.argsort(first_idx, kind="stable")
    rank_of_uniq = np.empty(len(uniq), dtype=np.int64)
    rank_of_uniq[occ_order] = np.arange(len(uniq))
    vox_of_point = rank_of_uniq[inv]
    num_vox = min(len(uniq), max_voxels)
    # each point's rank within its voxel, in scan order
    sort_idx = np.argsort(vox_of_point, kind="stable")
    sorted_vox = vox_of_point[sort_idx]
    counts_by_rank = counts[occ_order]
    starts = np.concatenate([[0], np.cumsum(counts_by_rank)[:-1]])
    rank_sorted = np.arange(len(sorted_vox)) - starts[sorted_vox]
    keep = (sorted_vox < num_vox) & (rank_sorted < max_points)
    voxels = np.zeros((num_vox, max_points, points.shape[1]),
                      dtype=points.dtype)
    voxels[sorted_vox[keep], rank_sorted[keep]] = points[
        pidx[sort_idx[keep]]]
    num_points_per_voxel = np.minimum(counts_by_rank[:num_vox],
                                      max_points).astype(np.int32)
    return voxels, _coors(uniq[occ_order[:num_vox]], grid_size), \
        num_points_per_voxel


def points_to_voxel_numpy(points, voxel_size, coors_range, max_points=35,
                          max_voxels=20000):
    """``points_to_voxel(..., sort_by_key=True)`` in numpy: the C
    voxelizer's reference."""
    points = np.asarray(points)
    grid_size, pidx, key = _cells(points, voxel_size, coors_range)
    if len(pidx) == 0:
        return _empty(points, max_points)
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
    return voxels, _coors(skey[starts[:num_vox]], grid_size), \
        num_points_per_voxel


def encode_compact_value_labels(voxel_labels, ignore_id=0):
    """Voxel label = the single (+1-shifted) label present, else ignore.

    voxel_labels: [Nv, P] int array, 0 = padding slot. Returns [Nv] labels
    shifted back by -1 (ambiguous voxels -> ignore_id).
    """
    voxel_labels = np.asarray(voxel_labels)
    pos = voxel_labels > 0
    mx = voxel_labels.max(axis=1)
    mixed = np.any(pos & (voxel_labels != mx[:, None]), axis=1)
    enc = np.where(mixed | (mx == 0), ignore_id + 1, mx)
    return (enc - 1).astype(voxel_labels.dtype)


def encode_major_value_labels(voxel_labels, ignore_id=0):
    """Voxel label = the most frequent (+1-shifted) label of its points,
    the smallest label among ties, else ignore (as np.unique + argmax
    pick). voxel_labels: [Nv, P] int array, 0 = padding slot."""
    voxel_labels = np.asarray(voxel_labels)
    pos = voxel_labels > 0
    # counts[i, j] = multiplicity of voxel_labels[i, j] among valid slots
    eq = voxel_labels[:, :, None] == voxel_labels[:, None, :]
    counts = (eq & pos[:, None, :]).sum(axis=2)
    # score favours a high count, then a small label; padding excluded
    score = counts.astype(np.float64) * 1e9 - voxel_labels
    score[~pos] = -np.inf
    best = np.argmax(score, axis=1)
    enc = voxel_labels[np.arange(len(voxel_labels)), best]
    enc = np.where(pos.any(axis=1), enc, ignore_id + 1)
    return (enc - 1).astype(voxel_labels.dtype)


class VoxelGenerator:
    """API of the JAX package's VoxelGenerator (key-sorted output unless
    ``sort_by_key=False``)."""

    def __init__(self, voxel_size, point_cloud_range, max_num_points,
                 max_voxels=20000, sort_by_key=True):
        self._sort_by_key = sort_by_key
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
                               self._max_num_points, max_voxels,
                               sort_by_key=self._sort_by_key)

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
