"""Second-stage BEV feature extraction at proposal centres (PyTorch port of
lidarseg3d_tpu/models/second_stage/bev_extractor.py): bilinear
interpolation of the stride-``out_stride`` BEV map at each proposal's
centre, or at 5 points (the centre and the four side midpoints) when
``num_point`` is 5, batched.

The port's BEV map is NCHW ([B, C, H, W], the RPN's output); it is sampled
in that layout by gathers over the flattened H * W axis, with the JAX
package's clamping: the four neighbours' indices are clamped into the map
separately, the weights are not, so a point beyond an edge extrapolates
from the edge's cells as JAX's does.
"""

import torch
from torch import nn

from ..registry import SECOND_STAGE


def bilinear_interpolate(fmap, xs, ys):
    """fmap [B, C, H, W]; xs, ys [B, N] continuous pixel coordinates ->
    [B, N, C] (torch-parity clamped bilinear, the JAX package's
    ``bilinear_interpolate`` per batch row)."""
    B, C, H, W = fmap.shape
    x0 = torch.floor(xs).to(torch.int64).clamp(0, W - 1)
    x1 = (x0 + 1).clamp(0, W - 1)
    y0 = torch.floor(ys).to(torch.int64).clamp(0, H - 1)
    y1 = (y0 + 1).clamp(0, H - 1)
    flat = fmap.reshape(B, C, H * W)

    def at(y, x):
        idx = (y * W + x)[:, None, :].expand(B, C, y.shape[1])
        return flat.gather(2, idx).transpose(1, 2)  # [B, N, C]

    fx0, fx1 = x0.to(xs.dtype), x1.to(xs.dtype)
    fy0, fy1 = y0.to(ys.dtype), y1.to(ys.dtype)
    wa = (fx1 - xs) * (fy1 - ys)
    wb = (fx1 - xs) * (ys - fy0)
    wc = (xs - fx0) * (fy1 - ys)
    wd = (xs - fx0) * (ys - fy0)
    return (at(y0, x0) * wa[..., None] + at(y1, x0) * wb[..., None]
            + at(y0, x1) * wc[..., None] + at(y1, x1) * wd[..., None])


def box_sample_points(boxes, num_point):
    """[B, N, 7] -> [B, N * num_point, 3] sample locations: the centres, or
    the centres then the front, back, left and right midpoints (±dx/2 and
    ±dy/2 rotated by the heading), each group of N in box order."""
    if num_point == 1:
        return boxes[..., :3]
    cx, cy, z = boxes[..., 0], boxes[..., 1], boxes[..., 2]
    dx, dy = boxes[..., 3], boxes[..., 4]
    c, s = torch.cos(boxes[..., 6]), torch.sin(boxes[..., 6])
    offs = [(dx / 2, 0.0 * dx), (-dx / 2, 0.0 * dx),
            (0.0 * dy, dy / 2), (0.0 * dy, -dy / 2)]
    pts = [torch.stack([cx, cy, z], -1)]
    for ox, oy in offs:
        pts.append(torch.stack([cx + ox * c - oy * s, cy + ox * s + oy * c,
                                z], -1))
    return torch.cat(pts, dim=1)


@SECOND_STAGE.register_module
class BEVFeatureExtractor(nn.Module):
    def __init__(self, pc_start=(), voxel_size=(), out_stride=8):
        super().__init__()
        self.pc_start = tuple(float(v) for v in pc_start)
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.out_stride = out_stride

    def forward(self, bev_feature, centers):
        """bev_feature [B, C, H, W]; centers [B, M, 3] -> [B, M, C]."""
        xs = ((centers[..., 0] - self.pc_start[0]) / self.voxel_size[0]
              / self.out_stride)
        ys = ((centers[..., 1] - self.pc_start[1]) / self.voxel_size[1]
              / self.out_stride)
        return bilinear_interpolate(bev_feature, xs, ys)
