"""The C voxelizer (csrc/voxelize.c), loaded with ctypes: the key-sorted
hard voxelization of ``core.voxelize.points_to_voxel`` for float32 points,
byte-identical to its numpy path and many times faster.

The library is built at first use by ops/cuda_build.py with the system C
compiler, as the JPEG entropy coder is. If it cannot be built or loaded,
``points_to_voxel_native`` raises (the JAX package falls back to numpy
without a word); ``core.voxelize`` keeps the numpy path for the inputs
the C code does not take: other dtypes and grids of 2^32 cells or more.
"""

import ctypes

import numpy as np

_P = ctypes.c_void_p
_I64 = ctypes.c_int64


def _lib():
    from ..ops import cuda_build

    try:
        return cuda_build.load("voxelize", {
            "voxelize_sorted": [_P, _I64, _I64, _P, _P, _I64, _I64, _P, _P,
                                _P, _P]}, restype=_I64)
    except (RuntimeError, OSError) as e:
        raise RuntimeError(f"the C voxelizer (csrc/voxelize.c) could not be "
                           f"built or loaded: {e}") from e


def serves(points, grid_size):
    """Whether the C voxelizer takes this input: 2-D float32 points on a
    grid of fewer than 2^32 cells."""
    return (points.dtype == np.float32 and points.ndim == 2
            and int(np.prod(grid_size)) < 2 ** 32)


def points_to_voxel_native(points, voxel_size, coors_range, max_points,
                           max_voxels, grid_size):
    """-> (voxels [M, max_points, D], coors [M, 3] (z, y, x) int32,
    num_points_per_voxel [M] int32), as ``points_to_voxel(...,
    sort_by_key=True)``."""
    points = np.ascontiguousarray(points, np.float32)
    n, d = points.shape
    vs = np.ascontiguousarray(voxel_size, np.float32)
    cr = np.ascontiguousarray(coors_range, np.float32)
    gs = np.ascontiguousarray(grid_size, np.int64)
    cap = max(int(max_voxels), 0)
    voxels = np.zeros((cap, max_points, d), np.float32)
    coors = np.zeros((cap, 3), np.int32)
    nump = np.zeros((cap,), np.int32)
    nv = _lib().voxelize_sorted(
        points.ctypes.data, n, d, vs.ctypes.data, cr.ctypes.data,
        max_points, cap, gs.ctypes.data, voxels.ctypes.data,
        coors.ctypes.data, nump.ctypes.data)
    if nv < 0:
        raise MemoryError("the C voxelizer could not allocate its sort "
                          "buffers")
    return voxels[:nv], coors[:nv], nump[:nv]
