"""Point devoxelization of the reference: each point takes the inverse
distance blend (weights 1 / (d^2 + 1e-8), normalized) of the 3 nearest
active voxel centres among the 27 voxels around its own cell, in raster
order, the first of equal distances winning. A point with none of them
active takes instead the two voxels whose rank in key order is that of
the largest active cell at or below its own and the next one; its own
cell is first clamped into the grid's cells and to the largest cell of a
point of its sample that lies in the grid in z and y (the port's rule on
the sorted-keys table, which the published SemanticKITTI grid takes).

Candidates are found by ``sparse.lookup``; the distances are computed in
the port's order of float operations, so that a tie breaks alike on both
sides.
"""

import torch

from . import sparse as sp

_RASTER27 = [(dz, dy, dx) for dz in (-1, 0, 1) for dy in (-1, 0, 1)
             for dx in (-1, 0, 1)]


def _point_voxel_coords(points_xyz, voxel_size, point_cloud_range):
    dev = points_xyz.device
    vs = torch.tensor(voxel_size, dtype=torch.float32, device=dev)
    org = torch.tensor(point_cloud_range[:3], dtype=torch.float32, device=dev)
    return torch.floor((points_xyz - org) / vs).flip(-1).to(torch.int32)


def _separable_d2(pxyz, pv, voxel_size, point_cloud_range):
    """[27, B, N] squared distances to the 27 cell centres around pv."""
    vx, vy, vz = (float(v) for v in voxel_size)
    ox, oy, oz = (float(v) for v in point_cloud_range[:3])
    fx = pxyz[..., 0] - ((pv[..., 2].to(torch.float32) + 0.5) * vx + ox)
    fy = pxyz[..., 1] - ((pv[..., 1].to(torch.float32) + 0.5) * vy + oy)
    fz = pxyz[..., 2] - ((pv[..., 0].to(torch.float32) + 0.5) * vz + oz)
    dx2 = {-1: (fx + vx) ** 2, 0: fx ** 2, 1: (fx - vx) ** 2}
    dy2 = {-1: (fy + vy) ** 2, 0: fy ** 2, 1: (fy - vy) ** 2}
    dz2 = {-1: (fz + vz) ** 2, 0: fz ** 2, 1: (fz - vz) ** 2}
    return torch.stack([dz2[dz] + dy2[dy] + dx2[dx]
                        for dz, dy, dx in _RASTER27])


def _fallback(index, struct, pv, pxyz, valid, missed, voxel_size,
              point_cloud_range):
    """The two rank-order candidates of the points in ``missed``:
    (d2 [2, B, N], flat rows [2, B, N])."""
    Z, Y, X = (int(s) for s in struct.spatial_shape)
    B, V = struct.coords.shape[:2]
    dev = pv.device
    p = pv.to(torch.int64)
    ext = (p[..., 0] * Y + p[..., 1]) * (X + 2) + p[..., 2] + 1
    nce = Z * Y * (X + 2)
    inb = (valid & (p[..., 0] >= 0) & (p[..., 0] < Z) & (p[..., 1] >= 0)
           & (p[..., 1] < Y) & (p[..., 2] >= -1) & (p[..., 2] <= X))
    cell = ext.clamp(0, nce - 1)
    cell = torch.minimum(cell, torch.where(inb, cell, 0).amax(
        dim=1, keepdim=True))
    # active cells in the same extended numbering, ascending with the keys
    vk = index.keys
    vz, rem = vk // (Y * X), vk % (Y * X)
    vext = torch.where(vk == sp.INVALID_KEY, torch.iinfo(torch.int64).max,
                       (vz * Y + rem // X) * (X + 2) + rem % X + 1)
    rank_m1 = torch.searchsorted(vext, cell, right=True) - 1
    nv = index.num[:, None]
    ok = missed & valid & (nv > 0)
    vs = torch.tensor(voxel_size, dtype=torch.float32, device=dev)
    org = torch.tensor(point_cloud_range[:3], dtype=torch.float32,
                       device=dev)
    offs = (torch.arange(B, device=dev, dtype=torch.int64) * V)[:, None]
    ds, rows = [], []
    for rr in (rank_m1, rank_m1 + 1):
        pos = torch.minimum(rr.clamp(min=0), (nv - 1).clamp(min=0))
        row = torch.gather(index.rows, 1, pos)
        czyx = torch.gather(struct.coords, 1,
                            row[..., None].expand(B, row.shape[1], 3))
        ctr = (czyx.flip(-1).to(torch.float32) + 0.5) * vs + org
        d2 = ((pxyz - ctr) ** 2).sum(dim=-1)
        ds.append(torch.where(ok, d2, torch.inf))
        rows.append(torch.where(ok, row + offs, B * V))
    return torch.stack(ds), torch.stack(rows)


def grid_three_interpolate(points_xyz, point_valid, struct, features,
                           voxel_size, point_cloud_range, table, k=3,
                           subm_rulebook=None):
    """points_xyz [B, N, 3], point_valid [B, N], the stride-1 structure
    with its features [B, V, C] and its ``sparse.KeyIndex`` -> [B, N, C].
    ``subm_rulebook`` is accepted for the copied heads' call and unused."""
    B, N, _ = points_xyz.shape
    V = struct.capacity
    dev = points_xyz.device
    pv = _point_voxel_coords(points_xyz, voxel_size, point_cloud_range)
    offs = (torch.arange(B, device=dev, dtype=torch.int64) * V)[:, None]
    d2 = _separable_d2(points_xyz, pv, voxel_size, point_cloud_range)
    cand_d, cand_i = [], []
    for j, (dz, dy, dx) in enumerate(_RASTER27):
        q = pv.to(torch.int64) + torch.tensor([dz, dy, dx], device=dev)
        row, found = sp.lookup(table, q, point_valid)
        cand_d.append(torch.where(found, d2[j], torch.inf))
        cand_i.append(torch.where(found, row + offs, B * V))
    cand_d, cand_i = torch.stack(cand_d), torch.stack(cand_i)
    missed = ~torch.any(torch.isfinite(cand_d), dim=0)
    fd, fi = _fallback(table, struct, pv, points_xyz, point_valid, missed,
                       voxel_size, point_cloud_range)
    cand_d = torch.cat([cand_d, fd])
    cand_i = torch.cat([cand_i, fi])

    # the k nearest, the first of equal distances winning
    ar = torch.arange(cand_d.shape[0], device=dev).view(-1, 1, 1)
    best_d, best_a = [], []
    d = cand_d
    for _ in range(k):
        a = torch.argmin(d, dim=0)
        best_d.append(torch.amin(d, dim=0))
        best_a.append(a)
        d = torch.where(ar == a[None], torch.inf, d)
    best_d = torch.stack(best_d)
    best_i = torch.gather(cand_i, 0, torch.stack(best_a))
    recip = torch.where(torch.isfinite(best_d), 1.0 / (best_d + 1e-8), 0.0)
    w = recip / torch.clamp(recip.sum(dim=0), min=1e-12)
    flat = sp.flat_features(features)
    C = features.shape[-1]
    out = torch.zeros(B, N, C, dtype=features.dtype, device=dev)
    for j in range(k):
        g = flat.index_select(0, best_i[j].reshape(-1))
        out = out + g.reshape(B, N, C) * w[j][..., None]
    return out * point_valid[..., None].to(out.dtype)
