"""Shared building blocks (PyTorch port of lidarseg3d_tpu/models/layers.py).

Naming: the port names its submodules after the scopes Flax generates for
the JAX package's modules (``TorchLinear_0``, ``MaskedBatchNorm_1``, ...),
so a ``state_dict`` key is the Flax parameter path with ``/`` read as
``.``; convert.py relies on that. ``Scopes`` hands out those names.

The benchmark loads every parameter from its own seeded draw, so the
port's ``init_parameters`` is not copied.
"""

import torch
import torch.nn.functional as F
from torch import nn

from . import dist
from . import remat


class Scopes:
    """Per-class counters that reproduce Flax's auto-naming (Class_N)."""

    def __init__(self):
        self._counts = {}

    def __call__(self, cls_name):
        n = self._counts.get(cls_name, 0)
        self._counts[cls_name] = n + 1
        return f"{cls_name}_{n}"


def add(parent, scopes, module):
    """Register ``module`` under its Flax-style name and return it. Keep the
    returned reference in a plain list, not in a module attribute (that
    would register it a second time under the attribute's name)."""
    parent.add_module(scopes(type(module).__name__), module)
    return module


class TorchLinear(nn.Linear):
    """nn.Linear; the Flax kernel is [in, out], torch's weight [out, in]."""


class MaskedBatchNorm(nn.Module):
    """BatchNorm with validity masking and the JAX package's parameters
    (scale, bias, running mean/var) on channel dim ``channel_dim``.

    In training mode the statistics run over the masked entries of all
    other dims (``mask`` has x's shape without the channel dim; None means
    every entry) and, in a multi-process run, of every rank (the sums go
    through ``parallel.dist.all_reduce_sum``, gradients included; a rank
    without a valid entry is legal), with ``cnt = max(sum(mask), 1)``: the
    biased variance normalizes, the unbiased one (``var * cnt / max(cnt -
    1, 1)``) goes into the running variance, with torch momentum semantics
    ``running = (1 - m) * running + m * batch``; the running statistics
    are updated in place, outside the autograd graph, and not again when a
    recomputed region (utils/remat.py) runs the layer a second time for
    the backward. In evaluation mode
    the running statistics normalize. Statistics are computed in
    ``promote_types(dtype, float32)`` and the input's dtype is returned.
    The JAX package's ``sub_groups`` is its space-to-depth layout and has
    no counterpart here."""

    def __init__(self, num_features, eps=1e-5, channel_dim=-1, momentum=0.1):
        super().__init__()
        self.eps = eps
        self.channel_dim = channel_dim
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x, mask=None):
        cd = self.channel_dim % x.dim()
        shape = [1] * x.dim()
        shape[cd] = -1
        xs = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.training:
            dims = [d for d in range(x.dim()) if d != cd]
            mf = None if mask is None else mask.to(xs.dtype).unsqueeze(cd)
            if mf is None:
                s1 = xs.sum(dims)
                n = s1.new_full((), float(x.numel() // x.shape[cd]))
            else:
                s1 = (xs * mf).sum(dims)
                n = mf.sum()
            if dist.active():  # statistics over every rank's entries
                tot = dist.all_reduce_sum(torch.cat([s1, n.view(1)]))
                s1, n = tot[:-1], tot[-1]
            cnt = n.clamp(min=1.0)
            mean = s1 / cnt
            dev2 = (xs - mean.view(shape)) ** 2
            var = dist.all_reduce_sum(
                (dev2 if mf is None else dev2 * mf).sum(dims)) / cnt
            unbias = cnt / (cnt - 1.0).clamp(min=1.0)
            if remat.phase() != "recompute":
                self._update_running(mean, var, unbias)
        else:
            mean, var = self.running_mean, self.running_var
        y = ((xs - mean.view(shape)) * torch.rsqrt(var + self.eps).view(shape)
             * self.weight.view(shape) + self.bias.view(shape))
        return y.to(x.dtype)

    @torch.no_grad()
    def _update_running(self, mean, var, unbias):
        m = self.momentum
        rm, rv = self.running_mean, self.running_var
        rm.mul_(1 - m).add_((m * mean).to(rm.dtype))
        rv.mul_(1 - m).add_((m * (var * unbias)).to(rv.dtype))


class MLPHead(nn.Module):
    """[Linear(no bias) + BN + ReLU] * len(fcs) + Linear(bias)."""

    def __init__(self, in_features, fcs, out_features, bn_eps=1e-5):
        super().__init__()
        s = Scopes()
        self.layers = []
        c = in_features
        for f in fcs:
            self.layers.append((add(self, s, TorchLinear(c, f, bias=False)),
                                add(self, s, MaskedBatchNorm(f, eps=bn_eps))))
            c = f
        self.layers.append((add(self, s, TorchLinear(c, out_features)), None))

    def forward(self, x, mask=None):
        for lin, bn in self.layers:
            x = lin(x) if bn is None else F.relu(bn(lin(x), mask=mask))
        return x

