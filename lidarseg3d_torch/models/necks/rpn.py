"""RPN neck of the detection stack (PyTorch port of
lidarseg3d_tpu/models/necks/rpn.py): downsample blocks (a strided 3x3 conv
and ``layer_num`` 3x3 convs, each with BN eps=1e-3 momentum=0.01 and
ReLU), upsample branches (a transposed conv, or a 1x1 conv at stride 1)
and their concat. NCHW.

The JAX package's Flax ``nn.ConvTranspose`` (SAME padding,
``transpose_kernel=False``) with kernel == stride equals
``nn.ConvTranspose2d`` with the kernel flipped in both spatial axes;
convert.py flips it. The first conv's input width is the backbone's
output (``in_channels``), which the JAX package's ``nn.Conv`` infers:
the published VoxelNet configs' ``num_input_features=256`` is not what
their backbone gives (ROADMAP §C).
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import MaskedBatchNorm, Scopes, add
from ..registry import NECKS


class Conv(nn.Conv2d):
    """nn.Conv2d under the Flax scope name Conv_i; ``bias_fill`` /
    ``weight_fill``: a constant initializer (models/layers.py)."""

    def __init__(self, *args, bias_fill=None, weight_fill=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.bias_fill, self.weight_fill = bias_fill, weight_fill


class ConvTranspose(nn.ConvTranspose2d):
    """nn.ConvTranspose2d under the Flax scope name ConvTranspose_i."""


def _bn(c):
    return MaskedBatchNorm(c, eps=1e-3, channel_dim=1, momentum=0.01)


class ConvBlock(nn.Module):
    def __init__(self, in_channels, features, stride, num_layers):
        super().__init__()
        s = Scopes()
        self.layers = []
        for i in range(num_layers + 1):
            conv = add(self, s, Conv(in_channels if i == 0 else features,
                                     features, 3, stride if i == 0 else 1,
                                     1, bias=False))
            self.layers.append((conv, add(self, s, _bn(features))))

    def forward(self, x):
        for conv, bn in self.layers:
            x = F.relu(bn(conv(x)))
        return x


@NECKS.register_module
class RPN(nn.Module):
    def __init__(self, layer_nums=(5, 5), ds_layer_strides=(1, 2),
                 ds_num_filters=(128, 256), us_layer_strides=(1, 2),
                 us_num_filters=(256, 256), num_input_features=256,
                 norm_cfg=None, logger=None, in_channels=None):
        super().__init__()
        s = Scopes()
        c = num_input_features if in_channels is None else in_channels
        start = len(layer_nums) - len(us_layer_strides)
        self.stages = []
        for i, ln in enumerate(layer_nums):
            block = add(self, s, ConvBlock(c, ds_num_filters[i],
                                           ds_layer_strides[i], ln))
            c = ds_num_filters[i]
            up = None
            if i - start >= 0:
                stride = us_layer_strides[i - start]
                feat = us_num_filters[i - start]
                if stride > 1:
                    conv = add(self, s, ConvTranspose(c, feat, stride,
                                                      stride, bias=False))
                else:
                    conv = add(self, s, Conv(c, feat, 1, bias=False))
                up = (conv, add(self, s, _bn(feat)))
            self.stages.append((block, up))
        self.out_channels = sum(us_num_filters[:len(layer_nums) - start])

    def forward(self, x):
        ups = []
        for block, up in self.stages:
            x = block(x)
            if up is not None:
                conv, bn = up
                ups.append(F.relu(bn(conv(x))))
        return torch.cat(ups, dim=1) if len(ups) > 1 else ups[0]
