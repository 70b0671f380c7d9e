"""PointPillars pillar encoder (PFN) and dense BEV scatter (PyTorch port of
lidarseg3d_tpu/models/readers/pillar_encoder.py) on the padded
[B, V, P, D] voxel layout: per-point decorations (offset from the pillar's
point mean and from the pillar centre, optionally the distance), PFN
layers (Linear -> BN -> ReLU -> max over the points, the max broadcast
back and concatenated in all but the last layer), then the pillar
features scattered onto the [B, C, ny, nx] canvas (NCHW).

BN: statistics over every point slot of the real pillars (a padded slot
is zero but counted, as in the reference), the capacity padding rows
masked out.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import MaskedBatchNorm, TorchLinear
from ..registry import BACKBONES, READERS


class PFNLayer(nn.Module):
    def __init__(self, in_channels, out_channels, last_layer=False,
                 bn_eps=1e-3, bn_momentum=0.01):
        super().__init__()
        self.last_layer = last_layer
        units = out_channels if last_layer else out_channels // 2
        self.TorchLinear_0 = TorchLinear(in_channels, units, bias=False)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(units, eps=bn_eps,
                                                 momentum=bn_momentum)

    def forward(self, x, point_mask, voxel_mask):
        """x [B, V, P, Cin]; point_mask [B, V, P]; voxel_mask [B, V]."""
        x = self.TorchLinear_0(x)
        bn_mask = voxel_mask[:, :, None].expand(x.shape[:3])
        x = F.relu(self.MaskedBatchNorm_0(x, mask=bn_mask))
        x = x * point_mask[..., None]
        x_max = x.amax(dim=2, keepdim=True)
        if self.last_layer:
            return x_max[:, :, 0, :]
        return torch.cat([x, x_max.expand(x.shape)], dim=-1)


@READERS.register_module
class PillarFeatureNet(nn.Module):
    def __init__(self, num_input_features=4, num_filters=(64,),
                 with_distance=False, voxel_size=(0.2, 0.2, 4),
                 pc_range=(0, -40, -3, 70.4, 40, 1), norm_cfg=None):
        super().__init__()
        self.with_distance = with_distance
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.pc_range = tuple(float(v) for v in pc_range)
        filters = list(num_filters)
        c = num_input_features + 5 + int(with_distance)
        for i, f in enumerate(filters):
            setattr(self, f"PFNLayer_{i}",
                    PFNLayer(c, f, last_layer=(i == len(filters) - 1)))
            c = f
        self.num_layers = len(filters)
        self.out_channels = filters[-1]

    def forward(self, voxels, num_points, coordinates):
        """voxels [B, V, P, D]; num_points [B, V]; coordinates [B, V, 3]
        (z, y, x) -> pillar features [B, V, C]."""
        B, V, P, D = voxels.shape
        vmask = num_points > 0
        pmask = (torch.arange(P, device=voxels.device)[None, None, :]
                 < num_points[:, :, None])
        n = num_points.clamp(min=1).to(voxels.dtype)[:, :, None]
        pm = pmask.to(voxels.dtype)
        xyz = voxels[..., :3]
        mean = (xyz * pm[..., None]).sum(dim=2, keepdim=True) / n[..., None]
        f_cluster = xyz - mean
        vx, vy = self.voxel_size[0], self.voxel_size[1]
        cx = coordinates[..., 2].to(voxels.dtype) * vx + (vx / 2
                                                          + self.pc_range[0])
        cy = coordinates[..., 1].to(voxels.dtype) * vy + (vy / 2
                                                          + self.pc_range[1])
        f_center = torch.stack([voxels[..., 0] - cx[:, :, None],
                                voxels[..., 1] - cy[:, :, None]], dim=-1)
        feats = [voxels, f_cluster, f_center]
        if self.with_distance:
            feats.append(torch.linalg.vector_norm(xyz, dim=-1, keepdim=True))
        x = torch.cat(feats, dim=-1) * pm[..., None]
        for i in range(self.num_layers):
            x = getattr(self, f"PFNLayer_{i}")(x, pm, vmask)
        return x * vmask[..., None].to(x.dtype)


@BACKBONES.register_module
class PointPillarsScatter(nn.Module):
    """Pillar features onto the dense BEV canvas [B, C, ny, nx]."""

    def __init__(self, num_input_features=64, norm_cfg=None):
        super().__init__()

    def forward(self, pillar_features, coordinates, num_voxels, input_shape):
        """pillar_features [B, V, C]; coordinates [B, V, 3] (z, y, x);
        input_shape (nz, ny, nx) or (ny, nx)."""
        ny, nx = (int(s) for s in tuple(input_shape)[-2:])
        B, V, C = pillar_features.shape
        dev = pillar_features.device
        valid = torch.arange(V, device=dev)[None, :] < num_voxels[:, None]
        c = coordinates.to(torch.int64)
        cell = c[..., 1] * nx + c[..., 2]
        offs = torch.arange(B, device=dev)[:, None] * (ny * nx)
        tgt = torch.where(valid, cell + offs, B * ny * nx)
        canvas = pillar_features.new_zeros(B * ny * nx + 1, C).index_put(
            (tgt.reshape(-1),), pillar_features.reshape(-1, C))
        return canvas[:-1].view(B, ny, nx, C).permute(0, 3, 1, 2).contiguous()
