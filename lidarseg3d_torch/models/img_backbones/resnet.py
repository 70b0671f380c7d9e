"""ResNet image backbone, mmseg's ResNetV1c (PyTorch port of
lidarseg3d_tpu/models/img_backbones/resnet.py:25 ResNetMMCV), an
alternative camera encoder: the deep stem (three 3x3 ConvBNReLUs, the
first at stride 2; else one 7x7 stride-2 conv and BN), a 3x3 stride-2
max pool, and four stages of Bottleneck (depths 50, 101) or BasicBlock
(18, 34) blocks, the planes doubling and the resolution halving at each
stage after the first; the stages in ``out_indices`` are returned. NCHW.

``frozen_stages=s`` as the JAX package reads it: the stem's BN runs on
running statistics in training once ``s >= 0``, stage i's (1-based) once
``s >= i``, and a frozen stage's output is detached, so no gradient
reaches the stem or stages 1..s. ``norm_eval`` is accepted and, as in the
JAX package, not read. ``compute_dtype`` casts the input; the convs follow
their input's dtype.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import MaskedBatchNorm, Scopes, add
from ..registry import IMG_BACKBONES
from .hrnet import BasicBlock, Bottleneck, ConvBNReLU, conv_as_input

ARCH = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
}


@IMG_BACKBONES.register_module
class ResNetMMCV(nn.Module):
    def __init__(self, depth=50, base_channels=64, out_indices=(0, 1, 2, 3),
                 frozen_stages=-1, deep_stem=True, pretrained=None,
                 norm_eval=False, compute_dtype=None, in_channels=3):
        super().__init__()
        self.compute_dtype = (None if compute_dtype is None
                              else getattr(torch, compute_dtype))
        self.frozen_stages, self.deep_stem = frozen_stages, deep_stem
        self.out_indices = tuple(out_indices)
        block_type, blocks = ARCH[depth]
        c = base_channels
        s = Scopes()
        if deep_stem:
            self.stem = [add(self, s, ConvBNReLU(in_channels, c // 2,
                                                 stride=2)),
                         add(self, s, ConvBNReLU(c // 2, c // 2)),
                         add(self, s, ConvBNReLU(c // 2, c))]
        else:  # the Flax scopes Conv_0 and MaskedBatchNorm_0
            self.Conv_0 = nn.Conv2d(in_channels, c, 7, 2, 3, bias=False)
            self.MaskedBatchNorm_0 = MaskedBatchNorm(c, channel_dim=1)
            self.stem = [self.Conv_0, self.MaskedBatchNorm_0]
        self.stages = []
        cin = c
        for si, nb in enumerate(blocks):
            planes = c * 2 ** si
            stage = []
            for bi in range(nb):
                stride = 2 if si > 0 and bi == 0 else 1
                if block_type == "bottleneck":
                    stage.append(add(self, s, Bottleneck(cin, planes,
                                                         stride=stride)))
                    cin = planes * 4
                else:
                    if stride == 2:
                        stage.append(add(self, s, ConvBNReLU(cin, planes,
                                                             stride=2)))
                    stage.append(add(self, s, BasicBlock(planes, planes)))
                    cin = planes
            self.stages.append(stage)

    def frozen_parameters(self):
        """Names of the parameters no gradient reaches: the stem and
        stages 1..frozen_stages."""
        if self.frozen_stages < 1:
            return []
        parts = self.stem + [m for st in self.stages[:self.frozen_stages]
                             for m in st]
        ids = {id(p) for m in parts for p in m.parameters()}
        return [n for n, p in self.named_parameters() if id(p) in ids]

    def train(self, mode=True):
        """Training mode, the BN of the stem (``frozen_stages >= 0``) and
        of stages 1..frozen_stages left on running statistics."""
        super().train(mode)
        if mode and self.frozen_stages >= 0:
            parts = self.stem + [m for st in
                                 self.stages[:self.frozen_stages]
                                 for m in st]
            for part in parts:
                for m in part.modules():
                    if isinstance(m, MaskedBatchNorm):
                        m.eval()
        return self

    def forward(self, x):
        """x: [N, 3, H, W] -> the NCHW maps of the stages in
        ``out_indices`` (1/4 .. 1/32)."""
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        if self.deep_stem:
            for m in self.stem:
                x = m(x)
        else:
            x = F.relu(self.stem[1](conv_as_input(self.stem[0], x)))
        x = F.max_pool2d(x, 3, 2, 1)
        outs = []
        for si, stage in enumerate(self.stages):
            for m in stage:
                x = m(x)
            if self.frozen_stages >= si + 1:
                x = x.detach()
            if si in self.out_indices:
                outs.append(x)
        return outs
