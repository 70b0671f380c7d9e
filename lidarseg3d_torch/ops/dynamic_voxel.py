"""Dynamic voxelization in the model and the per-voxel segment reductions
(PyTorch port of lidarseg3d_tpu/ops/dynamic_voxel.py).

The voxel set of a batch of points is deduplicated with the sparse conv
stack's own ``unique_coords`` and lookup tables: each point finds its
voxel's row through ``coords.lookup_coords`` (the merge kernel on a
KeyTable, the single-cell rank-table kernel on a RankTable). Reductions
run over the padded voxel rows with ``index_put_`` (accumulating, in a
fixed order) and ``scatter_reduce_``; a point without a voxel goes to a
trailing row that is dropped.
"""

import torch

from . import coords as coord_ops
from . import sparse as sp


def assign_points_to_voxels(point_coords, point_valid, spatial_shape,
                            capacity):
    """Build the voxel structure from per-point integer grid coords.

    point_coords: [B, N, 3] int32 (z, y, x); point_valid: [B, N] bool.
    Returns (struct, p2v [B, N] int32 local voxel row, found [B, N] bool).
    """
    coords, num, _ = sp.unique_coords(point_coords, point_valid,
                                      spatial_shape, capacity)
    struct = sp.build_structure(coords, num, spatial_shape)
    table = sp.dense_table(struct)
    p2v, found = coord_ops.lookup_coords(
        table, point_coords.to(torch.int32), struct.spatial_shape,
        extra_valid=point_valid)
    return struct, p2v, found


def _flat_targets(p2v, found, capacity):
    """[B, N] local rows -> flat rows into [B*cap + 1]; misses -> B*cap."""
    B = p2v.shape[0]
    offs = (torch.arange(B, dtype=torch.int64, device=p2v.device)
            * capacity)[:, None]
    return torch.where(found, p2v.to(torch.int64) + offs, B * capacity)


def scatter_sum(rows, tgt, values):
    """[rows, C] sums of values [M, C] by target row tgt [M], in the same
    order on every run: index_put's accumulate sorts the targets, where
    index_add_ adds atomically on a card, in whatever order its threads
    run, and so would change the rounding of a sum (and a near-tied label)
    between two runs on the same inputs."""
    return values.new_zeros(rows, values.shape[-1]).index_put(
        (tgt,), values, accumulate=True)


def segment_sum(values, p2v, found, capacity):
    """values [B, N, C] -> [B, cap, C] summed per voxel."""
    B, N, C = values.shape
    tgt = _flat_targets(p2v, found, capacity).reshape(-1)
    out = scatter_sum(B * capacity + 1, tgt, values.reshape(B * N, C))
    return out[:-1].reshape(B, capacity, C)


def segment_mean(values, p2v, found, capacity):
    B, N, _ = values.shape
    s = segment_sum(values, p2v, found, capacity)
    cnt = segment_sum(values.new_ones(B, N, 1), p2v, found, capacity)
    return s / cnt.clamp(min=1.0)


def segment_max(values, p2v, found, capacity, neg_fill=0.0):
    """Per-voxel max; empty voxels get ``neg_fill``."""
    B, N, C = values.shape
    tgt = _flat_targets(p2v, found, capacity).reshape(-1)
    out = values.new_full((B * capacity + 1, C), -torch.inf)
    out = out.scatter_reduce(0, tgt[:, None].expand(B * N, C),
                             values.reshape(B * N, C), "amax")
    out = out[:-1].reshape(B, capacity, C)
    return torch.where(torch.isfinite(out), out, neg_fill)


def segment_label_vote(labels, p2v, found, capacity, num_classes):
    """Majority-vote voxel labels (the first of equal counts): labels
    [B, N] int (train ids) -> [B, cap] int32; empty voxels get 0."""
    B, N = labels.shape
    tgt = _flat_targets(p2v, found, capacity).reshape(-1)
    cls = labels.reshape(-1).clamp(0, num_classes - 1).to(torch.int64)
    hist = torch.zeros(B * capacity + 1, num_classes, dtype=torch.int32,
                       device=labels.device)
    hist.index_put_((tgt, cls), torch.ones_like(cls, dtype=torch.int32),
                    accumulate=True)
    return hist[:-1].reshape(B, capacity, num_classes).argmax(-1).to(
        torch.int32)


def cart2cylind(points_xyz):
    """[..., 3] (x, y, z) -> (rho, phi, z)."""
    x, y = points_xyz[..., 0], points_xyz[..., 1]
    rho = torch.sqrt(x ** 2 + y ** 2)
    phi = torch.atan2(y, x)
    return torch.stack([rho, phi, points_xyz[..., 2]], dim=-1)


def grid_coords_from_metric(points, lower, upper, grid_size):
    """metric coords [..., 3] -> (int grid coords [..., 3], in-bounds
    mask): floor((p - lo) / interval), out-of-range points masked out. The
    output's axis order is the input's."""
    kw = dict(dtype=torch.float32, device=points.device)
    lo, up = torch.tensor(lower, **kw), torch.tensor(upper, **kw)
    gs = torch.tensor(grid_size, **kw)
    c = torch.floor((points - lo) / ((up - lo) / gs))
    inb = torch.all((c >= 0) & (c < gs), dim=-1)
    return c.to(torch.int32), inb
