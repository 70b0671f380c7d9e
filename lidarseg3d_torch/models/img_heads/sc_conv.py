"""Self-calibrated convolution (SCNet) blocks of the image head (PyTorch
port of lidarseg3d_tpu/models/img_heads/sc_conv.py:19 SCConv and :42
SCBottleneck).

SCConv gates a 3x3 branch with sigmoid(x + up(BN(conv(avgpool_r(x))))),
the gate computed at 1/r resolution and upsampled bilinearly; SCBottleneck
splits the channels into a plain 3x3 path and an SCConv path and adds the
residual (FCNMSeg3DHead's ``use_sc_conv``). NCHW; every conv runs in its
input's dtype with fp32 parameters (``conv_as_input``), BN as
layers.MaskedBatchNorm. Submodule names follow the JAX package's Flax
scopes (Conv_i, MaskedBatchNorm_i, SCConv_0).
"""

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.resize import resize_bilinear
from ..img_backbones.hrnet import conv_as_input
from ..layers import MaskedBatchNorm, Scopes, add


class Conv(nn.Conv2d):
    """nn.Conv2d registered under the Flax scope name Conv_i."""


def _conv_bn(parent, s, cin, cout, kernel):
    """Register a Conv_i / MaskedBatchNorm_i pair on ``parent`` in the
    order the Flax module creates them; -> [conv, bn]."""
    return [add(parent, s, Conv(cin, cout, kernel, padding=kernel // 2,
                                bias=False)),
            add(parent, s, MaskedBatchNorm(cout, channel_dim=1))]


def _apply(pair, x):
    return pair[1](conv_as_input(pair[0], x))


class SCConv(nn.Module):
    def __init__(self, planes, pooling_r=4):
        super().__init__()
        s = Scopes()
        self.pooling_r = pooling_r
        self.k2 = _conv_bn(self, s, planes, planes, 3)
        self.k3 = _conv_bn(self, s, planes, planes, 3)
        self.k4 = _conv_bn(self, s, planes, planes, 3)

    def forward(self, x):
        r = self.pooling_r
        k2 = _apply(self.k2, F.avg_pool2d(x, r, r))
        gate = torch.sigmoid(x + resize_bilinear(k2, x.shape[-2:]))
        return _apply(self.k4, _apply(self.k3, x) * gate)


class SCBottleneck(nn.Module):
    def __init__(self, in_channels, planes, bottleneck_width=32,
                 pooling_r=4):
        super().__init__()
        gw = int(planes * (bottleneck_width / 64.0))
        s = Scopes()
        self.a1 = _conv_bn(self, s, in_channels, gw, 1)
        self.b1 = _conv_bn(self, s, in_channels, gw, 1)
        self.a2 = _conv_bn(self, s, gw, gw, 3)
        self.sc = [add(self, s, SCConv(gw, pooling_r=pooling_r))]
        self.out = _conv_bn(self, s, 2 * gw, planes, 1)

    def forward(self, x):
        a = F.relu(_apply(self.a2, F.relu(_apply(self.a1, x))))
        b = F.relu(self.sc[0](F.relu(_apply(self.b1, x))))
        return F.relu(_apply(self.out, torch.cat([a, b], dim=1)) + x)
