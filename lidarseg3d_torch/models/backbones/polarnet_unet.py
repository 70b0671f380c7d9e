"""PolarNet's BEV UNet (PyTorch port of
lidarseg3d_tpu/models/backbones/polarnet_unet.py): a dense 2-D UNet
(64-128-256-512-512, bilinear upsampling) over the polar BEV grid with
circular padding along the azimuth, LeakyReLU after BN, DropBlock on the
decoder, and a 1x1 head of n_class * n_height channels read as [B, R, P,
n_height, n_class] logits. NCHW inside, NHWC at the boundary as in the
JAX package. No Pallas kernel in the JAX package: dense convolutions
(cuDNN on the card), as HRNet. Submodule names follow the JAX package's
Flax scopes.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.resize import resize_bilinear
from ...parallel import dist
from ..layers import MaskedBatchNorm
from ..registry import BACKBONES


def circular_pad_phi(x):
    """NCHW [B, C, R, P]: wrap-pad the phi (W) axis by 1, zero-pad R by 1."""
    x = torch.cat([x[..., -1:], x, x[..., :1]], dim=-1)
    return F.pad(x, (0, 0, 1, 1))


def dropblock_mask(shape, drop_prob, block_size, generator, device):
    """DropBlock's keep mask [B, 1, H, W] and its scale: seeds drawn
    with probability gamma from ``generator``, grown to block_size^2 blocks
    (max pool, stride 1, SAME), keep = 1 - block, scale = the mask's size
    / its kept count. In a multi-process run the mask and its scale are
    the global batch's, and each rank keeps its rows (parallel/dist.py)."""
    B, _, H, W = shape
    gamma = (drop_prob / block_size ** 2 * (H * W)
             / max((H - block_size + 1) * (W - block_size + 1), 1))
    u = torch.rand((B * dist.world_size(), 1, H, W), generator=generator,
                   device=device)
    seeds = (u < gamma).to(torch.float32)
    block = F.max_pool2d(seeds, block_size, stride=1,
                         padding=block_size // 2)
    keep = 1.0 - block
    return (dist.local_rows(keep),
            keep.numel() / keep.sum().clamp(min=1.0))


class DropBlock2D(nn.Module):
    """DropBlock (Ghiasi et al.): in training, drop contiguous blocks of
    the feature map, drawing from the generator the forward is given."""

    def __init__(self, drop_prob=0.5, block_size=7):
        super().__init__()
        self.drop_prob, self.block_size = drop_prob, block_size

    def forward(self, x, generator=None):
        if not self.training or self.drop_prob == 0.0:
            return x
        keep, scale = dropblock_mask(x.shape, self.drop_prob,
                                     self.block_size, generator, x.device)
        return x * keep.to(x.dtype) * scale


class DoubleConvCircular(nn.Module):
    def __init__(self, in_channels, features):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_channels, features, 3)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(features, channel_dim=1)
        self.Conv_1 = nn.Conv2d(features, features, 3)
        self.MaskedBatchNorm_1 = MaskedBatchNorm(features, channel_dim=1)

    def forward(self, x):
        for conv, bn in ((self.Conv_0, self.MaskedBatchNorm_0),
                         (self.Conv_1, self.MaskedBatchNorm_1)):
            x = F.leaky_relu(bn(conv(circular_pad_phi(x))), 0.01)
        return x


@BACKBONES.register_module
class PolarNet_BEV_Unet(nn.Module):
    def __init__(self, n_class=17, n_height=32, input_batch_norm=True,
                 dropout=0.5, circular_padding=True, use_vis_fea=False):
        super().__init__()
        self.n_class, self.n_height = n_class, n_height
        self.input_batch_norm = input_batch_norm
        if input_batch_norm:
            self.MaskedBatchNorm_0 = MaskedBatchNorm(n_height, channel_dim=1)
        chans = [(n_height, 64), (64, 128), (128, 256), (256, 512),
                 (512, 512), (1024, 256), (512, 128), (256, 64), (128, 64)]
        for i, (cin, cout) in enumerate(chans):
            self.add_module(f"DoubleConvCircular_{i}",
                            DoubleConvCircular(cin, cout))
        self.drops = nn.ModuleList(DropBlock2D(dropout) for _ in range(4))
        self.Conv_0 = nn.Conv2d(64, n_class * n_height, 1)

    def forward(self, bev, generator=None):
        """bev [B, R, P, n_height] -> logits [B, R, P, n_height, n_class];
        DropBlock draws from ``generator`` in training."""
        x = bev.permute(0, 3, 1, 2).contiguous()
        if self.input_batch_norm:
            x = self.MaskedBatchNorm_0(x)
        dc = [getattr(self, f"DoubleConvCircular_{i}") for i in range(9)]
        xs = [dc[0](x)]
        for i in range(1, 5):
            xs.append(dc[i](F.max_pool2d(xs[-1], 2, 2)))
        y = xs[4]
        for k, skip in enumerate((xs[3], xs[2], xs[1], xs[0])):
            a = resize_bilinear(y, skip.shape[-2:])
            y = self.drops[k](dc[5 + k](torch.cat([skip, a], dim=1)),
                              generator)
        logits = self.Conv_0(y).permute(0, 2, 3, 1)
        B, R, P, _ = logits.shape
        return logits.reshape(B, R, P, self.n_height, self.n_class)
