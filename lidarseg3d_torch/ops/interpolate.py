"""Point devoxelization: 3-NN inverse-distance interpolation of voxel
features (PyTorch port of lidarseg3d_tpu/ops/interpolate.py:32
grid_three_interpolate, its rulebook-reuse and sorted branches).

The 3 nearest active-voxel centers of a point lie (essentially always) in
its 3x3x3 voxel neighbourhood, so a point keeps the best 3 of 27
candidates, plus a rank-order fallback for points whose neighbourhood
holds no active voxel. Weights are 1/(d^2 + 1e-8), normalized.

- Rulebook reuse (a RankTable and the backbone's 27-tap subm rulebook): a
  point's own cell is an active voxel whenever the point is in the grid,
  so its 27 candidates are its voxel's rulebook row: one own-row lookup
  plus one 27-wide row gather.
- Sorted (any other RankTable, and every KeyTable): points sorted by cell,
  nine grouped triple-lookups (sparse.lookup_rank3_cells) resolve the 27
  candidates, and the result is un-permuted.
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
    stride-1 sparse tensor (struct, features [B, V, C]) with its lookup
    table and optionally its [27, B, V] subm rulebook. Returns [B, N, C]."""
    pv = _point_voxel_coords(points_xyz, voxel_size, point_cloud_range)
    # rulebook reuse only on RankTables, as in the JAX package: on a
    # KeyTable the own-row lookup would need the sort + merge anyway
    if (isinstance(table, coord_ops.RankTable) and subm_rulebook is not None
            and subm_rulebook.shape[0] == 27):
        return _grid_interp_rulebook(points_xyz, point_valid, struct,
                                     features, voxel_size, point_cloud_range,
                                     table, pv, k, subm_rulebook)
    if isinstance(table, (coord_ops.RankTable, coord_ops.KeyTable)):
        return _grid_interp_sorted(points_xyz, point_valid, struct, features,
                                   voxel_size, point_cloud_range, table, pv,
                                   k)
    raise TypeError(f"unknown table {type(table).__name__}")


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


def _grid_interp_sorted(points_xyz, point_valid, struct, features,
                        voxel_size, point_cloud_range, table, pv, k):
    """Sort points by extended cell (out-of-grid and invalid points last),
    resolve the 27 candidates with nine grouped triple-lookups, blend in
    sorted order, and un-permute. Candidate distances are separable: a
    found candidate's voxel is exactly pv + delta."""
    B, N, _ = points_xyz.shape
    V = struct.capacity
    Z, Y, X = (int(s) for s in struct.spatial_shape)
    dev = points_xyz.device

    pz, py, px = pv[..., 0], pv[..., 1], pv[..., 2]
    inb = ((pz >= 0) & (pz < Z) & (py >= 0) & (py < Y)
           & (px >= 0) & (px < X) & point_valid)
    cell = (pz * Y + py) * (X + 2) + (px + 1)
    sort_key = torch.where(inb, cell, coord_ops.INVALID_KEY)
    perm = torch.argsort(sort_key, dim=-1, stable=True)  # jnp.argsort's

    def take(a):
        return torch.gather(a, 1, perm)

    pxyz_s = torch.gather(points_xyz, 1, perm[..., None].expand(B, N, 3))
    cell_s, pz_s, py_s, px_s = take(cell), take(pz), take(py), take(px)
    valid_s = take(point_valid)

    # nine (dz, dy) groups; each triple covers dx in {-1, 0, 1}. The x
    # center may sit in the extended range [-1, X]: a point one cell
    # outside the grid still reaches the x=0 / x=X-1 neighbours.
    dzy = [(dz, dy) for dz in (-1, 0, 1) for dy in (-1, 0, 1)]
    cells = torch.stack([cell_s + (dz * Y + dy) * (X + 2) for dz, dy in dzy])
    inbs = torch.stack([
        valid_s & (pz_s + dz >= 0) & (pz_s + dz < Z)
        & (py_s + dy >= 0) & (py_s + dy < Y) & (px_s >= -1) & (px_s <= X)
        for dz, dy in dzy])
    (im, fm), (i0, f0), (ip, fp) = sp.lookup_rank3_cells(table, cells, inbs)

    idx27 = torch.stack([im, i0, ip], dim=1).reshape(27, B, N)
    fnd27 = torch.stack([fm, f0, fp], dim=1).reshape(27, B, N)
    offs = (torch.arange(B, dtype=torch.int32, device=dev) * V)[None, :, None]
    gidx27 = torch.where(fnd27, idx27 + offs, B * V).to(torch.int32)
    d2 = _separable_d2(pxyz_s, pz_s, py_s, px_s, voxel_size,
                       point_cloud_range, _RASTER27)
    cand_d = torch.where(fnd27, d2, torch.inf)
    # rank-1 of the point's own cell: the centre (dz, dy) group's raw i0,
    # read at every position (hence sparse.kernel_cells' clamp matters)
    cand_d, gidx27 = _append_rank_fallback(
        cand_d, gidx27, i0[4], struct, pxyz_s, valid_s, voxel_size,
        point_cloud_range)
    out_s = _interp_from_candidates(cand_d, gidx27, features, valid_s, k)
    inv = torch.empty_like(perm).scatter_(
        1, perm, torch.arange(N, device=dev).expand(B, N))
    C = out_s.shape[-1]
    return torch.gather(out_s, 1, inv[..., None].expand(B, N, C))
