"""Point devoxelization: 3-NN inverse-distance interpolation of voxel
features (PyTorch port of lidarseg3d_tpu/ops/interpolate.py:32
grid_three_interpolate, rulebook-reuse branch).

The 3 nearest active-voxel centers of a point lie (essentially always) in
its 3x3x3 voxel neighbourhood, and a point's own cell is an active voxel
whenever the point is in the grid, so its 27 candidates are its voxel's row
of the backbone's stride-1 subm rulebook: one own-row lookup plus one
27-wide row gather. Points without an active own cell take a rank-order
fallback. Weights are 1/(d^2 + 1e-8), normalized.
"""

import torch

from . import coords as coord_ops
from . import sparse as sp

_RASTER27 = [(dz, dy, dx) for dz in (-1, 0, 1) for dy in (-1, 0, 1)
             for dx in (-1, 0, 1)]


def _point_voxel_coords(points_xyz, voxel_size, point_cloud_range):
    """xyz points -> integer voxel coords in (z, y, x) order."""
    dev = points_xyz.device
    vs = torch.tensor(voxel_size, dtype=torch.float32, device=dev)
    org = torch.tensor(point_cloud_range[:3], dtype=torch.float32, device=dev)
    cxyz = torch.floor((points_xyz - org) / vs)
    return cxyz.flip(-1).to(torch.int32)


def grid_three_interpolate(points_xyz, point_valid, struct, features,
                           voxel_size, point_cloud_range, table, k=3,
                           subm_rulebook=None):
    """points_xyz [B, N, 3] metric xyz; point_valid [B, N] bool; the
    stride-1 sparse tensor (struct, features [B, V, C]) with its rank table
    and its [27, B, V] subm rulebook. Returns [B, N, C]."""
    if (not isinstance(table, coord_ops.RankTable) or subm_rulebook is None
            or subm_rulebook.shape[0] != 27):
        raise NotImplementedError(
            "the port devoxelizes through the rank table and the "
            "backbone's 27-tap subm rulebook; the sorted branch is not "
            "ported yet (ROADMAP.md B2)")
    pv = _point_voxel_coords(points_xyz, voxel_size, point_cloud_range)
    return _grid_interp_rulebook(points_xyz, point_valid, struct, features,
                                 voxel_size, point_cloud_range, table, pv, k,
                                 subm_rulebook)


def _small_topk(cand_d, k):
    """k smallest of [NC, B, N] along axis 0 by iterative argmin (first
    minimum wins, so the candidate order is the tie-break order)."""
    NC = cand_d.shape[0]
    ar = torch.arange(NC, device=cand_d.device).view(NC, 1, 1)
    best_d, best_i = [], []
    d = cand_d
    for _ in range(k):
        ba = torch.argmin(d, dim=0)
        best_d.append(torch.amin(d, dim=0))
        best_i.append(ba)
        d = torch.where(ar == ba[None], torch.inf, d)
    return torch.stack(best_d), torch.stack(best_i)


def _interp_from_candidates(cand_d, cand_i, features, point_valid, k):
    """Top-k inverse-distance blend; cand_d/cand_i [NC, B, N] squared
    distances (inf = miss) and GLOBAL flat feature rows."""
    B, N = cand_d.shape[1:]
    C = features.shape[-1]
    best_d, arg = _small_topk(cand_d, k)
    best_i = torch.gather(cand_i, 0, arg)  # [k, B, N]
    feats_flat = sp.flat_features(features)
    recip = torch.where(torch.isfinite(best_d), 1.0 / (best_d + 1e-8), 0.0)
    w = recip / torch.clamp(recip.sum(dim=0), min=1e-12)
    out = torch.zeros(B, N, C, dtype=features.dtype, device=features.device)
    for j in range(k):
        g = feats_flat.index_select(0, best_i[j].reshape(-1).to(torch.int64))
        out = out + g.reshape(B, N, C) * w[j][..., None]
    return out * point_valid[..., None].to(out.dtype)


def _append_rank_fallback(cand_d, gidx, rank_m1, struct, pxyz, valid,
                          voxel_size, point_cloud_range):
    """A point whose 3x3x3 neighbourhood holds no active voxel gets the
    voxel of rank ``rank_m1`` (the largest active cell <= its own) and its
    successor as extra candidates with their true distances.
    cand_d/gidx [27, B, N] -> [29, B, N]."""
    B, N = cand_d.shape[1:]
    V = struct.capacity
    dev = cand_d.device
    coords_flat = torch.cat([struct.coords.reshape(B * V, 3),
                             struct.coords.new_full((1, 3), -1)], dim=0)
    vs_xyz = torch.tensor(voxel_size, dtype=torch.float32, device=dev)
    org_xyz = torch.tensor(point_cloud_range[:3], dtype=torch.float32,
                           device=dev)
    missed = ~torch.any(torch.isfinite(cand_d), dim=0)
    nv = struct.num_voxels[:, None]
    offs = (torch.arange(B, dtype=torch.int32, device=dev) * V)[:, None]
    extras_d, extras_i = [], []
    for rr in (rank_m1, rank_m1 + 1):
        row = torch.minimum(torch.clamp(rr, min=0),
                            torch.clamp(nv - 1, min=0))
        ok = missed & valid & (nv > 0)
        g = torch.where(ok, row + offs, B * V).to(torch.int32)
        czyx = coords_flat.index_select(0, g.reshape(-1).to(torch.int64))
        ctr = ((czyx.reshape(B, N, 3).flip(-1).to(torch.float32) + 0.5)
               * vs_xyz + org_xyz)
        dd = ((pxyz - ctr) ** 2).sum(dim=-1)
        extras_d.append(torch.where(ok, dd, torch.inf))
        extras_i.append(g)
    return (torch.cat([cand_d, torch.stack(extras_d)], dim=0),
            torch.cat([gidx, torch.stack(extras_i)], dim=0))


def _separable_d2(pxyz, pz, py, px, voxel_size, point_cloud_range, order):
    """[27, B, N] candidate-center squared distances from nine per-axis
    tables: center(pv + delta) = center(pv) + delta * voxel_size."""
    vx, vy, vz = (float(v) for v in voxel_size)
    ox, oy, oz = (float(v) for v in point_cloud_range[:3])
    fx = pxyz[..., 0] - ((px.to(torch.float32) + 0.5) * vx + ox)
    fy = pxyz[..., 1] - ((py.to(torch.float32) + 0.5) * vy + oy)
    fz = pxyz[..., 2] - ((pz.to(torch.float32) + 0.5) * vz + oz)
    dx2 = {-1: (fx + vx) ** 2, 0: fx ** 2, 1: (fx - vx) ** 2}
    dy2 = {-1: (fy + vy) ** 2, 0: fy ** 2, 1: (fy - vy) ** 2}
    dz2 = {-1: (fz + vz) ** 2, 0: fz ** 2, 1: (fz - vz) ** 2}
    return torch.stack([dz2[dz] + dy2[dy] + dx2[dx] for dz, dy, dx in order])


def _grid_interp_rulebook(points_xyz, point_valid, struct, features,
                          voxel_size, point_cloud_range, table, pv, k, rb):
    """Subm-rulebook reuse: rb [27, B, V] global flat rows (raster tap
    order, miss = B*V) holds the 27 neighbours of every active voxel."""
    B, N, _ = points_xyz.shape
    V = struct.capacity
    dev = points_xyz.device
    row0, found0 = coord_ops.lookup_rank(table, pv, extra_valid=point_valid)
    rb_flat = torch.cat([rb.permute(1, 2, 0).reshape(B * V, 27),
                         rb.new_full((1, 27), B * V)], dim=0)
    offs_v = (torch.arange(B, dtype=torch.int32, device=dev) * V)[:, None]
    grow = torch.where(found0, row0 + offs_v, B * V).reshape(-1)
    gidx27 = rb_flat.index_select(0, grow.to(torch.int64)).reshape(
        B, N, 27).permute(2, 0, 1)
    d2 = _separable_d2(points_xyz, pv[..., 0], pv[..., 1], pv[..., 2],
                       voxel_size, point_cloud_range, _RASTER27)
    cand_d = torch.where(gidx27 != B * V, d2, torch.inf)
    cand_d, gidx27 = _append_rank_fallback(
        cand_d, gidx27, row0, struct, points_xyz, point_valid, voxel_size,
        point_cloud_range)
    return _interp_from_candidates(cand_d, gidx27, features, point_valid, k)
