"""PointNet++ point operations, batch variants (PyTorch port of
lidarseg3d_tpu/ops/pointnet2.py; plain torch, no kernel behind them in
either package): furthest point sampling, ball query and grouping. No
main path calls them; three_nn / three_interpolate live in
ops/interpolate.py.
"""

import torch


def furthest_point_sample(xyz, valid, num_samples):
    """xyz [N, 3]; valid [N] bool -> [num_samples] int32 indices. Starts
    from the first valid point; a padded point is never taken (its
    distance is -inf), the first furthest point wins a tie."""
    neg = torch.tensor(-float("inf"), dtype=xyz.dtype, device=xyz.device)
    mind = torch.where(valid, torch.full_like(xyz[:, 0], float("inf")), neg)
    idxs = torch.zeros(num_samples, dtype=torch.int32, device=xyz.device)
    last = torch.argmax(valid.to(torch.int32))
    idxs[0] = last
    for i in range(1, num_samples):
        d = ((xyz - xyz[last]) ** 2).sum(-1)
        mind = torch.minimum(mind, torch.where(valid, d, neg))
        last = torch.argmax(mind)
        idxs[i] = last
    return idxs


def ball_query(centers, xyz, valid, radius, nsample):
    """centers [M, 3]; xyz [N, 3]; valid [N] bool -> (idx [M, nsample]
    int32, count [M] int32): each centre's first ``nsample`` valid points
    (by index) within ``radius``; empty slots repeat the first hit, or 0
    without one."""
    d2 = ((centers[:, None, :] - xyz[None, :, :]) ** 2).sum(-1)
    inside = (d2 < radius ** 2) & valid[None, :]
    rank = torch.cumsum(inside.to(torch.int64), dim=1)  # 1-based for hits
    M, N = inside.shape
    slot = torch.where(inside & (rank <= nsample), rank - 1,
                       torch.full_like(rank, nsample))  # nsample: no slot
    idx = torch.full((M, nsample + 1), -1, dtype=torch.int64,
                     device=xyz.device)
    cols = torch.arange(N, device=xyz.device).expand(M, N)
    idx.scatter_reduce_(1, slot, cols, reduce="amax")
    idx = idx[:, :nsample]
    first = idx[:, :1].clamp(min=0)
    idx = torch.where(idx >= 0, idx, first)
    return idx.to(torch.int32), rank[:, -1].clamp(max=nsample).to(
        torch.int32)


def group_points(features, idx):
    """features [N, C]; idx [M, K] -> [M, K, C]."""
    M, K = idx.shape
    return features[idx.reshape(-1).long()].reshape(M, K, features.shape[-1])
