"""HRNetV2 image backbone (PyTorch port of
lidarseg3d_tpu/models/img_backbones/hrnet.py:341 HRNet, plain layout).

NCHW inside; stem (two stride-2 3x3), Bottleneck stage 1, multi-resolution
parallel branches with full fusion. ``compute_dtype="bfloat16"`` runs the
branch in mixed precision as the JAX package does: the input and every
activation in bf16, parameters kept in fp32 and cast at each conv, BN in
fp32 and cast back (layers.MaskedBatchNorm). The JAX package's space-to-depth
branch layout is TPU layout work with identical parameters, so the port
computes the same convs in the plain layout. Submodule names follow the
JAX package's Flax scopes (models/layers.py); HRModuleStack's nn.scan
becomes a ModuleList ``scan.{i}``.

Training options, as the JAX package reads them (its hrnet.py:362-403):
``frozen_stages=s`` runs the BN of the stem, stage 1 and stages 2..s on
their running statistics in training mode and detaches each frozen
stage's output, so no gradient reaches a frozen parameter (its gradient
is zero, and weight decay still shrinks it: the JAX package freezes with
``stop_gradient``, not by leaving the optimizer); ``norm_eval`` runs every
BN of the branch on running statistics in training; ``with_cp``
recomputes each HR module in the backward (utils/remat.py).
"""

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.resize import resize_bilinear
from ...utils.remat import remat
from ..layers import MaskedBatchNorm, Scopes, add
from ..registry import IMG_BACKBONES


def conv_as_input(conv, x):
    """Apply nn.Conv2d ``conv`` in x's dtype, its fp32 parameters cast at
    the call (the JAX package's ``conv(dtype=x.dtype)``)."""
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    return F.conv2d(x, conv.weight.to(x.dtype), bias, conv.stride,
                    conv.padding)


class ConvBNReLU(nn.Module):
    def __init__(self, in_channels, features, kernel=3, stride=1, relu=True):
        super().__init__()
        pad = kernel // 2
        self.Conv_0 = nn.Conv2d(in_channels, features, kernel, stride, pad,
                                bias=False)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(features, channel_dim=1)
        self.relu = relu

    def forward(self, x):
        x = self.MaskedBatchNorm_0(conv_as_input(self.Conv_0, x))
        return F.relu(x) if self.relu else x


class BasicBlock(nn.Module):
    def __init__(self, in_channels, planes):
        super().__init__()
        s = Scopes()
        self.body = [add(self, s, ConvBNReLU(in_channels, planes)),
                     add(self, s, ConvBNReLU(planes, planes, relu=False))]
        self.down = []
        if in_channels != planes:
            self.down.append(add(self, s, ConvBNReLU(
                in_channels, planes, kernel=1, relu=False)))

    def forward(self, x):
        y = self.body[1](self.body[0](x))
        return F.relu(y + (self.down[0](x) if self.down else x))


class Bottleneck(nn.Module):
    def __init__(self, in_channels, planes, stride=1, expansion=4):
        super().__init__()
        out_c = planes * expansion
        s = Scopes()
        self.body = [add(self, s, ConvBNReLU(in_channels, planes, kernel=1)),
                     add(self, s, ConvBNReLU(planes, planes, stride=stride)),
                     add(self, s, ConvBNReLU(planes, out_c, kernel=1,
                                             relu=False))]
        self.down = []
        if in_channels != out_c or stride != 1:
            self.down.append(add(self, s, ConvBNReLU(
                in_channels, out_c, kernel=1, stride=stride, relu=False)))

    def forward(self, x):
        y = x
        for m in self.body:
            y = m(y)
        identity = self.down[0](x) if self.down else x
        return F.relu(y + identity)


class HRModule(nn.Module):
    """Parallel branches + full multi-resolution fusion."""

    def __init__(self, num_branches, num_blocks, num_channels):
        super().__init__()
        s = Scopes()
        self.num_branches = num_branches
        self.branches = []
        for i in range(num_branches):
            self.branches.append([
                add(self, s, BasicBlock(num_channels[i], num_channels[i]))
                for _ in range(num_blocks[i])])
        # fuse[i][j]: the layers taking branch j to branch i
        self.fuse = []
        for i in range(num_branches):
            row = []
            for j in range(num_branches):
                if j > i:  # 1x1 conv + BN at branch-j res, then upsample
                    row.append([add(self, s, ConvBNReLU(
                        num_channels[j], num_channels[i], kernel=1,
                        relu=False))])
                elif j < i:  # (i-j) stride-2 3x3 convs
                    chain = []
                    for k in range(i - j):
                        last = k == i - j - 1
                        chain.append(add(self, s, ConvBNReLU(
                            num_channels[j],
                            num_channels[i] if last else num_channels[j],
                            stride=2, relu=not last)))
                    row.append(chain)
                else:
                    row.append([])
            self.fuse.append(row)

    def forward(self, xs):
        outs = []
        for i, blocks in enumerate(self.branches):
            x = xs[i]
            for blk in blocks:
                x = blk(x)
            outs.append(x)
        fused = []
        for i in range(self.num_branches):
            acc = None
            for j in range(self.num_branches):
                y = outs[j]
                for m in self.fuse[i][j]:
                    y = m(y)
                if j > i:
                    y = resize_bilinear(y, outs[i].shape[-2:])
                acc = y if acc is None else acc + y
            fused.append(F.relu(acc))
        return fused


class HRModuleStack(nn.Module):
    """num_modules HRModules (an nn.scan in the JAX package); with
    ``remat`` each module is recomputed in the backward, as the JAX
    package's nn.remat of the scan body."""

    def __init__(self, num_modules, num_branches, num_blocks, num_channels,
                 remat=False):
        super().__init__()
        self.remat = remat
        self.scan = nn.ModuleList(
            HRModule(num_branches, num_blocks, num_channels)
            for _ in range(num_modules))

    def forward(self, xs):
        for m in self.scan:
            xs = (remat(lambda *a, m=m: m(list(a)), *xs) if self.remat
                  else m(xs))
        return xs


@IMG_BACKBONES.register_module
class HRNet(nn.Module):
    def __init__(self, extra=None, norm_cfg=None, norm_eval=False,
                 frozen_stages=-1, pretrained=None, in_channels=3,
                 with_cp=False, compute_dtype=None, s2d_max_c=18):
        super().__init__()
        self.compute_dtype = (None if compute_dtype is None
                              else getattr(torch, compute_dtype))
        self.norm_eval, self.frozen_stages = norm_eval, frozen_stages
        s = Scopes()
        stem = [add(self, s, ConvBNReLU(in_channels, 64, stride=2)),
                add(self, s, ConvBNReLU(64, 64, stride=2))]
        s1 = extra["stage1"]
        planes = s1["num_channels"][0]
        layer1, c = [], 64
        for _ in range(s1["num_blocks"][0]):
            layer1.append(add(self, s, Bottleneck(c, planes)))
            c = planes * 4
        self.stem, self.layer1 = stem, layer1
        self.stages = []
        prev = [c]
        for key in ("stage2", "stage3", "stage4"):
            cfg = extra[key]
            nb = cfg["num_branches"]
            chans = tuple(cfg["num_channels"])
            trans = []
            for i in range(nb):
                if i < len(prev):
                    trans.append(add(self, s, ConvBNReLU(prev[i], chans[i]))
                                 if prev[i] != chans[i] else None)
                else:  # new branch from the last existing one
                    trans.append(add(self, s, ConvBNReLU(
                        prev[-1], chans[i], stride=2)))
            stack = add(self, s, HRModuleStack(
                cfg["num_modules"], nb, tuple(cfg["num_blocks"]), chans,
                remat=with_cp))
            self.stages.append((trans, stack))
            prev = list(chans)

    def frozen_parts(self):
        """The submodules of the frozen stages: the stem and stage 1 when
        ``frozen_stages >= 1``, stage si's transitions and HR modules when
        ``frozen_stages >= si``."""
        parts = self.stem + self.layer1 if self.frozen_stages >= 1 else []
        for si, (trans, stack) in enumerate(self.stages, start=2):
            if self.frozen_stages >= si:
                parts += [t for t in trans if t is not None] + [stack]
        return parts

    def frozen_parameters(self):
        """Names of the parameters no gradient reaches (frozen stages)."""
        ids = {id(p) for m in self.frozen_parts() for p in m.parameters()}
        return [n for n, p in self.named_parameters() if id(p) in ids]

    def train(self, mode=True):
        """Training mode, with the BN of the frozen stages (of the whole
        branch under ``norm_eval``) left on running statistics."""
        super().train(mode)
        if mode:
            for part in [self] if self.norm_eval else self.frozen_parts():
                for m in part.modules():
                    if isinstance(m, MaskedBatchNorm):
                        m.eval()
        return self

    def forward(self, x):
        """x: [N, 3, H, W] -> list of 4 NCHW maps (1/4 .. 1/32), in
        ``compute_dtype`` when one is set."""
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        for m in self.stem:
            x = m(x)
        for m in self.layer1:
            x = m(x)
        if self.frozen_stages >= 1:
            x = x.detach()
        xs = [x]
        for si, (trans, stack) in enumerate(self.stages, start=2):
            new_xs = []
            for i, t in enumerate(trans):
                src = xs[i] if i < len(xs) else xs[-1]
                new_xs.append(src if t is None else t(src))
            xs = stack(new_xs)
            if self.frozen_stages >= si:
                xs = [v.detach() for v in xs]
        return xs
