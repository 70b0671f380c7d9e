"""Voxel feature extractors (PyTorch port of
lidarseg3d_tpu/models/readers/voxel_encoders.py): MeanVoxelFeatureExtractor,
ImprovedMeanVoxelFeatureExtractor and SDSeg3D's
TransformerVoxelFeatureExtractor (TransVFE) with its pre-norm encoder
layers.

Quirks kept for parity: the per-point padding mask is sum(features) != 0,
and TransVFE's encoder runs unmasked over all P slots of a voxel (no key
padding mask), padded slots and padded voxel rows included.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ...utils import remat
from ..layers import TorchLinear
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


def _check_width(features, num_input_features):
    if features.shape[-1] != num_input_features:
        raise ValueError(f"expected {num_input_features} point features, "
                         f"got {features.shape[-1]}")


@READERS.register_module
class MeanVoxelFeatureExtractor(nn.Module):
    """The mean of each voxel's point features."""

    def __init__(self, num_input_features=4, **kwargs):
        super().__init__()
        self.num_input_features = num_input_features

    def forward(self, features, num_voxels, coors=None):
        _check_width(features, self.num_input_features)
        nv = torch.clamp(num_voxels, min=1).to(features.dtype)[..., None]
        return features.sum(dim=2) / nv


@READERS.register_module
class ImprovedMeanVoxelFeatureExtractor(nn.Module):
    def __init__(self, num_input_features=4, norm_cfg=None):
        super().__init__()
        self.num_input_features = num_input_features

    def forward(self, features, num_voxels, coors=None):
        _check_width(features, self.num_input_features)
        desc, _ = _descriptor(features, num_voxels)
        return desc


def token_attention(q, k, v, nhead):
    """Multi-head self-attention over the P tokens of each voxel, in plain
    ops (the JAX package's tiny_token_attention, a custom VJP for the
    TPU's lanes; autograd gives the same gradient here). q/k/v [N, P, E]
    -> [N, P, E]: softmax over the key tokens of q k^T * d**-0.5, no mask,
    no dropout."""
    N, P, E = q.shape
    d = E // nhead

    def heads(x):
        return x.reshape(N, P, nhead, d).transpose(1, 2)  # [N, h, P, d]

    scores = heads(q) @ heads(k).transpose(-1, -2) * d ** -0.5
    out = torch.softmax(scores, dim=-1) @ heads(v)  # [N, h, P, d]
    return out.transpose(1, 2).reshape(N, P, E)


class TransformerEncoderLayerPreNorm(nn.Module):
    """Pre-norm encoder layer (dropout 0): x + out(attn(LN(x))), then
    x + FFN(LN(x)) with a ReLU FFN of width ``dim_feedforward``. Linear
    names follow the JAX layer's Flax scopes: q, k, v, out, FFN in, FFN
    out."""

    def __init__(self, d_model, nhead, dim_feedforward):
        super().__init__()
        self.nhead = nhead
        self.LayerNorm_0 = nn.LayerNorm(d_model, eps=1e-5)
        self.TorchLinear_0 = TorchLinear(d_model, d_model)  # q
        self.TorchLinear_1 = TorchLinear(d_model, d_model)  # k
        self.TorchLinear_2 = TorchLinear(d_model, d_model)  # v
        self.TorchLinear_3 = TorchLinear(d_model, d_model)  # out
        self.LayerNorm_1 = nn.LayerNorm(d_model, eps=1e-5)
        self.TorchLinear_4 = TorchLinear(d_model, dim_feedforward)
        self.TorchLinear_5 = TorchLinear(dim_feedforward, d_model)

    def forward(self, src):
        x = self.LayerNorm_0(src)
        attn = token_attention(self.TorchLinear_0(x), self.TorchLinear_1(x),
                               self.TorchLinear_2(x), self.nhead)
        src = src + self.TorchLinear_3(attn)
        x = F.relu(self.TorchLinear_4(self.LayerNorm_1(src)))
        return src + self.TorchLinear_5(x)


@READERS.register_module
class TransformerVoxelFeatureExtractor(nn.Module):
    """TransVFE (SDSeg3D's reader): each point's features with its voxel's
    descriptor, a linear embedding, ``num_layers`` pre-norm encoder layers
    over the voxel's P slots, the max over the slots, then
    relu(linear(num_compressed_features)) when that is > 0.

    The JAX package scans the layers (their Flax parameters carry a
    leading layer axis, which convert.py unstacks into ``EncoderLayers``)
    and always recomputes each one in the backward (nn.remat); here each
    layer is a ``utils.remat`` region whenever gradients are recorded."""

    def __init__(self, num_input_features=4, num_compressed_features=16,
                 num_embed=64, num_head=4, num_layers=2, norm_cfg=None):
        super().__init__()
        self.num_input_features = num_input_features
        self.num_compressed_features = num_compressed_features
        self.num_embed = num_embed
        # the descriptor: mean/max/min xyz, the other channels' means,
        # density and std
        n_desc = 9 + (num_input_features - 3) + 2
        self.TorchLinear_0 = TorchLinear(num_input_features + n_desc,
                                         num_embed)
        self.EncoderLayers = nn.ModuleList(
            TransformerEncoderLayerPreNorm(num_embed, num_head, 2 * num_embed)
            for _ in range(num_layers))
        if num_compressed_features > 0:
            self.TorchLinear_1 = TorchLinear(num_embed,
                                             num_compressed_features)

    def forward(self, features, num_voxels, coors=None):
        _check_width(features, self.num_input_features)
        B, V, P, _ = features.shape
        desc, _ = _descriptor(features, num_voxels)
        desc = desc[:, :, None, :].expand(B, V, P, desc.shape[-1])
        x = self.TorchLinear_0(torch.cat([features, desc], dim=-1))
        x = x.reshape(B * V, P, self.num_embed)
        for layer in self.EncoderLayers:
            x = remat.remat(layer, x)
        out = torch.amax(x.reshape(B, V, P, self.num_embed), dim=2)
        if self.num_compressed_features > 0:
            out = F.relu(self.TorchLinear_1(out))
        return out
