"""Shared building blocks (PyTorch port of lidarseg3d_tpu/models/layers.py).

Naming: the port names its submodules after the scopes Flax generates for
the JAX package's modules (``TorchLinear_0``, ``MaskedBatchNorm_1``, ...),
so a ``state_dict`` key is the Flax parameter path with ``/`` read as
``.``; convert.py relies on that. ``Scopes`` hands out those names.

Initialization: ``init_parameters`` fills every parameter from an explicit
``torch.Generator`` with the JAX package's initializer for it:
U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for ``TorchLinear`` weights and biases
and sparse-conv kernels (the package's ``torch_uniform_init``); Flax's
defaults for its ``nn.Conv`` / ``nn.ConvTranspose`` and the attention's
``DenseGeneral`` projections (here ``nn.Conv2d`` / ``nn.ConvTranspose2d``
and plain ``nn.Linear``): ``lecun_normal`` kernels (a normal truncated at
2 sigma, scaled to a standard deviation of 1/sqrt(fan_in)) and zero
biases; U(-sqrt(3/fan_in), sqrt(3/fan_in)) for the DCN kernel
(``variance_scaling(1, "fan_in", "uniform")``); ones/zeros for norms; BN
running stats 0/1; a module's ``weight_fill`` / ``bias_fill`` (the JAX
package's constant initializers) last.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import dist
from ..utils import remat


# the standard deviation of a unit normal truncated at +-2 (Flax's
# variance_scaling divides by it)
TRUNC_NORMAL_STD = 0.87962566103423978


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


@torch.no_grad()
def init_parameters(model, generator):
    """Seeded initialization (see module docstring); ``generator`` is a
    CPU torch.Generator, values are copied to each parameter's device."""

    def uniform_(t, bound):
        v = torch.rand(t.shape, generator=generator, dtype=torch.float32)
        t.copy_((v * 2 - 1) * bound)

    def lecun_normal_(t, fan_in):
        # Flax's truncated_normal(-2, 2) by its inverse CDF, then scaled
        # so that the truncated draw has a variance of 1 / fan_in
        lo, hi = (0.5 * (1 + math.erf(z / math.sqrt(2))) for z in (-2, 2))
        u = torch.rand(t.shape, generator=generator, dtype=torch.float64)
        z = torch.erfinv(2 * (lo + u * (hi - lo)) - 1) * math.sqrt(2)
        t.copy_(z * (1 / math.sqrt(fan_in) / TRUNC_NORMAL_STD))

    def flax_default_(m, fan_in):
        lecun_normal_(m.weight, fan_in)
        if m.bias is not None:
            m.bias.zero_()

    for m in model.modules():
        if isinstance(m, TorchLinear):
            bound = 1.0 / math.sqrt(m.in_features)
            uniform_(m.weight, bound)
            if m.bias is not None:
                uniform_(m.bias, bound)
        elif isinstance(m, nn.Linear):
            flax_default_(m, m.in_features)
        elif isinstance(m, nn.Conv2d):
            flax_default_(m, m.weight[0].numel())
        elif isinstance(m, nn.ConvTranspose2d):
            flax_default_(m, m.weight[:, 0].numel())
        elif isinstance(m, (MaskedBatchNorm, nn.LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.fill_(0.0)
            if isinstance(m, MaskedBatchNorm):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
        elif hasattr(m, "sparse_weight_fan_in"):
            uniform_(m.weight, 1.0 / math.sqrt(m.sparse_weight_fan_in))
        elif hasattr(m, "deform_kernel"):  # [K, C, Cout]: fan_in K * C
            K, C, _ = m.deform_kernel.shape
            uniform_(m.deform_kernel, math.sqrt(3.0 / (K * C)))
        # the JAX package's constant initializers (CenterHead's heatmap
        # bias, the zero DCN offset convs)
        if getattr(m, "weight_fill", None) is not None:
            m.weight.fill_(m.weight_fill)
        if getattr(m, "bias_fill", None) is not None:
            m.bias.fill_(m.bias_fill)
