"""Bilinear point-to-pixel feature sampling (PyTorch port of
lidarseg3d_tpu/ops/grid_sample.py:13 sample_points_cuv).

The camera index is an exact integer (align_corners=True on the camera
axis), so each point gathers its 4 bilinear corners from its camera's map.
A point outside every camera (valid column 0) carries cam_id -100 from the
pipeline, far outside the cameras: its index is clamped into them before
the gather and its result zeroed. The JAX package gathers it out of
bounds, which gives NaN there (ROADMAP §C, reference fault 7).
"""

import torch


def sample_points_cuv(features, points_cuv):
    """features [B, num_cam, H, W, C]; points_cuv [B, N, 4] = [valid,
    cam_norm, v_norm, u_norm] in [-1, 1] (align_corners=True).
    Returns [B, N, C]; invalid points get zeros."""
    B, num_cam, H, W, C = features.shape
    N = points_cuv.shape[1]
    valid = points_cuv[..., 0] > 0.5
    if num_cam > 1:
        cam = torch.round((points_cuv[..., 1] + 1.0) * 0.5
                          * (num_cam - 1)).to(torch.int64).clamp(0,
                                                                 num_cam - 1)
    else:
        cam = torch.zeros(points_cuv.shape[:2], dtype=torch.int64,
                          device=points_cuv.device)
    v = (points_cuv[..., 2] + 1.0) * 0.5 * (H - 1)
    u = (points_cuv[..., 3] + 1.0) * 0.5 * (W - 1)
    v0 = torch.clamp(torch.floor(v), 0, H - 1)
    u0 = torch.clamp(torch.floor(u), 0, W - 1)
    v1 = torch.clamp(v0 + 1, 0, H - 1)
    u1 = torch.clamp(u0 + 1, 0, W - 1)
    wv, wu = v - v0, u - u0
    v0i, v1i, u0i, u1i = (a.to(torch.int64) for a in (v0, v1, u0, u1))
    flat = features.reshape(B * num_cam * H * W, C)
    base = (torch.arange(B, device=features.device)[:, None]
            * (num_cam * H * W) + cam * (H * W))

    def gather(vi, ui):
        return flat.index_select(0, (base + vi * W + ui).reshape(-1)
                                 ).reshape(B, N, C)

    out = (gather(v0i, u0i) * ((1 - wv) * (1 - wu))[..., None]
           + gather(v0i, u1i) * ((1 - wv) * wu)[..., None]
           + gather(v1i, u0i) * (wv * (1 - wu))[..., None]
           + gather(v1i, u1i) * (wv * wu)[..., None])
    return out * valid[..., None].to(out.dtype)
