"""Shared building blocks (PyTorch port of lidarseg3d_tpu/models/layers.py).

Naming: the port names its submodules after the scopes Flax generates for
the JAX package's modules (``TorchLinear_0``, ``MaskedBatchNorm_1``, ...),
so a ``state_dict`` key is the Flax parameter path with ``/`` read as
``.``; convert.py relies on that. ``Scopes`` hands out those names.

Initialization: ``init_parameters`` fills every parameter from an explicit
``torch.Generator`` with the JAX package's torch-default distributions:
U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for linear, conv and sparse-conv
weights and biases; ones/zeros for norms; BN running stats 0/1.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn


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
    """BatchNorm with the JAX package's parameters (scale, bias, running
    mean/var) on channel dim ``channel_dim``. Evaluation semantics only:
    normalize with the running statistics. Training-mode statistics are
    not ported yet (ROADMAP.md, training)."""

    def __init__(self, num_features, eps=1e-5, channel_dim=-1):
        super().__init__()
        self.eps = eps
        self.channel_dim = channel_dim
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x, mask=None):
        if self.training:
            raise NotImplementedError(
                "MaskedBatchNorm batch statistics (training) are not "
                "ported yet; call .eval()")
        shape = [1] * x.dim()
        shape[self.channel_dim] = -1
        inv = torch.rsqrt(self.running_var + self.eps)
        return ((x - self.running_mean.view(shape)) * inv.view(shape)
                * self.weight.view(shape) + self.bias.view(shape))


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

    def uniform_(t, fan_in):
        bound = 1.0 / math.sqrt(fan_in)
        v = torch.rand(t.shape, generator=generator, dtype=torch.float32)
        t.copy_((v * 2 - 1) * bound)

    for m in model.modules():
        if isinstance(m, nn.Linear):
            uniform_(m.weight, m.in_features)
            if m.bias is not None:
                uniform_(m.bias, m.in_features)
        elif isinstance(m, nn.Conv2d):
            fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
            uniform_(m.weight, fan_in)
            if m.bias is not None:
                uniform_(m.bias, fan_in)
        elif isinstance(m, (MaskedBatchNorm, nn.LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.fill_(0.0)
            if isinstance(m, MaskedBatchNorm):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
        elif hasattr(m, "sparse_weight_fan_in"):
            uniform_(m.weight, m.sparse_weight_fan_in)
