"""Voxel feature extractors (PyTorch port of the ImprovedMeanVFE part of
lidarseg3d_tpu/models/readers/voxel_encoders.py).

Quirk kept for parity: the per-point padding mask is sum(features) != 0.
"""

import torch
from torch import nn

from ..registry import READERS


def _descriptor(features, num_voxels):
    """mean/max/min xyz + extra-channel means + density + std.
    features [B, V, P, D]; num_voxels [B, V] -> ([B, V, 3+3+3+(D-3)+2],
    point_mask [B, V, P])."""
    P = features.shape[2]
    nv = torch.clamp(num_voxels, min=1).to(features.dtype)[..., None]
    points_mean = features.sum(dim=2) / nv  # [B, V, D]
    point_mask = (features.sum(dim=-1) != 0).to(features.dtype)  # [B, V, P]
    xyz = features[..., :3]
    big = (1.0 - point_mask)[..., None] * 1e5
    points_max = torch.amax(xyz - big, dim=2)
    points_min = torch.amin(xyz + big, dim=2)
    density = point_mask.sum(dim=-1, keepdim=True) / P
    norm = torch.linalg.vector_norm(
        (xyz - points_mean[..., None, :3]) * point_mask[..., None], dim=-1)
    std = (norm.sum(dim=2) / nv[..., 0])[..., None]
    return torch.cat([points_mean[..., :3], points_max, points_min,
                      points_mean[..., 3:], density, std], dim=-1), point_mask


@READERS.register_module
class ImprovedMeanVoxelFeatureExtractor(nn.Module):
    def __init__(self, num_input_features=4, norm_cfg=None):
        super().__init__()
        self.num_input_features = num_input_features

    def forward(self, features, num_voxels, coors=None):
        if features.shape[-1] != self.num_input_features:
            raise ValueError(f"expected {self.num_input_features} point "
                             f"features, got {features.shape[-1]}")
        desc, _ = _descriptor(features, num_voxels)
        return desc
