"""Sparse-conv layer zoo (PyTorch port of
lidarseg3d_tpu/models/sparse_modules.py).

Rulebooks are built once per structure by the backbone and passed in: the
reference's indice_key sharing as explicit rulebook reuse. Sparse weights
keep the JAX layout [K, Cin, Cout].
"""

import torch
import torch.nn.functional as F
from torch import nn

from . import sparse as sp
from .remat import remat
from .layers import MaskedBatchNorm, Scopes, add


class _SparseConvBase(nn.Module):
    def __init__(self, in_features, features, kernel_size=3):
        super().__init__()
        ks = sp._triple(kernel_size)
        K = ks[0] * ks[1] * ks[2]
        self.sparse_weight_fan_in = K * in_features
        self.weight = nn.Parameter(torch.empty(K, in_features, features))


class SubMConv3d(_SparseConvBase):
    def forward(self, st: sp.SparseTensor, rulebook):
        out = sp.subm_conv(st, self.weight, rulebook)
        return sp.SparseTensor(structure=st.structure, features=out)


class SparseConv3d(_SparseConvBase):
    """Strided conv onto a precomputed downsampled structure;
    ``rulebook_t`` is the paired inverse rulebook (backward)."""

    def forward(self, st: sp.SparseTensor, out_struct, rulebook,
                rulebook_t=None):
        out = sp.strided_conv(st, self.weight, rulebook, rulebook_t)
        return sp.SparseTensor(structure=out_struct, features=out)


class SparseInverseConv3d(_SparseConvBase):
    """``rulebook_t`` is the paired strided rulebook (backward)."""

    def forward(self, st_low: sp.SparseTensor, target_struct, rulebook,
                rulebook_t=None):
        out = sp.inverse_conv(st_low, self.weight, rulebook, rulebook_t)
        return sp.SparseTensor(structure=target_struct, features=out)


BN_MOMENTUM = 0.01  # every BN of the sparse backbone (the JAX package's)

_CONV_TYPES = {"subm": SubMConv3d, "spconv": SparseConv3d,
               "inverseconv": SparseInverseConv3d}


class SparseConvBNReLU(nn.Module):
    """conv + BN + ReLU (the reference's post_act_block)."""

    def __init__(self, in_features, features, kernel_size=3,
                 conv_type="subm", bn_eps=1e-3):
        super().__init__()
        if conv_type not in _CONV_TYPES:
            raise ValueError(conv_type)
        s = Scopes()
        self.conv_type = conv_type
        self.parts = [
            add(self, s, _CONV_TYPES[conv_type](in_features, features,
                                                kernel_size)),
            add(self, s, MaskedBatchNorm(features, eps=bn_eps,
                                         momentum=BN_MOMENTUM)),
        ]

    def forward(self, st, rulebook, out_struct=None, rulebook_t=None):
        conv, bn = self.parts
        if self.conv_type == "subm":
            out = conv(st, rulebook)
        else:
            out = conv(st, out_struct, rulebook, rulebook_t)
        f = bn(out.features, mask=out.valid_mask())
        return sp.SparseTensor(structure=out.structure, features=F.relu(f))


class SparseBasicBlock(nn.Module):
    """Residual block of two subm convs."""

    def __init__(self, features, bn_eps=1e-3):
        super().__init__()
        self.SubMConv3d_0 = SubMConv3d(features, features)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(features, bn_eps,
                                                 momentum=BN_MOMENTUM)
        self.SubMConv3d_1 = SubMConv3d(features, features)
        self.MaskedBatchNorm_1 = MaskedBatchNorm(features, bn_eps,
                                                 momentum=BN_MOMENTUM)

    def forward(self, st: sp.SparseTensor, rulebook):
        mask = st.valid_mask()
        identity = st.features
        f = self.SubMConv3d_0(st, rulebook).features
        f = F.relu(self.MaskedBatchNorm_0(f, mask=mask))
        st2 = sp.SparseTensor(structure=st.structure, features=f)
        f = self.MaskedBatchNorm_1(self.SubMConv3d_1(st2, rulebook).features,
                                   mask=mask)
        return sp.SparseTensor(structure=st.structure,
                               features=F.relu(f + identity))


class SparseBasicBlockStack(nn.Module):
    """n consecutive SparseBasicBlocks (an nn.scan in the JAX package; the
    scan's stacked weights unstack into ``blocks.{i}``). With ``remat``
    each block is recomputed in the backward (the JAX package's nn.remat of
    the scan body); the rulebook is built outside the recomputed region."""

    def __init__(self, features, n=2, remat=False):
        super().__init__()
        self.remat = remat
        self.blocks = nn.ModuleList(SparseBasicBlock(features)
                                    for _ in range(n))

    def forward(self, st: sp.SparseTensor, rulebook):
        f = st.features
        for blk in self.blocks:
            if self.remat:
                f = remat(lambda x, blk=blk: blk(
                    sp.SparseTensor(st.structure, x), rulebook).features, f)
            else:
                f = blk(sp.SparseTensor(st.structure, f), rulebook).features
        return sp.SparseTensor(structure=st.structure, features=f)
