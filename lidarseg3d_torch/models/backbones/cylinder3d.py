"""Cylinder3D's asymmetric sparse UNet (PyTorch port of
lidarseg3d_tpu/models/backbones/cylinder3d.py).

A context block, four asymmetric residual blocks with strided pooling
(strides (2,2,2) twice, then (2,2,1): the z axis, the structure's x, is
kept at the two deepest levels), four up blocks with inverse convs, the
sigmoid-gated reconstruction block and, unless ``return_sparse`` (the
_v2p variant), a final 3x3x3 subm classifier densified to [B, R, P, Z,
ncls] for the PolarNet-style point head. Axis order is (r, phi, z).

All structures, lookup tables and rulebooks are built once per forward by
``structures`` (one table per structure; one subm rulebook per structure
and kernel shape; one strided / inverse pair per stride, shared by the
pooling conv and the up block's inverse conv) and shared by the convs: the
JAX package's _RBCache, built ahead. The kernels (1,3,3) and (3,1,3) have
K = 9 taps, (1,1,3) K = 3; (3,1,1) and (1,3,1) are one tap wide in x
(sparse.py builds them from the 3-wide groups). Submodule names follow the
JAX package's Flax scopes.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import sparse as sp
from ..layers import MaskedBatchNorm
from ..registry import BACKBONES
from ..sparse_modules import SparseConv3d, SparseInverseConv3d, SubMConv3d

K13, K31, K33 = (1, 3, 3), (3, 1, 3), (3, 3, 3)
RECON = ((3, 1, 1), (1, 3, 1), (1, 1, 3))


class AsymmConvBNAct(nn.Module):
    """Subm conv, then act -> BN (``act_first``) or BN -> act."""

    def __init__(self, in_features, features, kernel_size=K33, act="leaky",
                 act_first=True):
        super().__init__()
        self.kernel_size = tuple(kernel_size)
        self.act, self.act_first = act, act_first
        self.SubMConv3d_0 = SubMConv3d(in_features, features, kernel_size)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(features)

    def _act(self, x):
        if self.act == "leaky":
            return F.leaky_relu(x, 0.01)
        if self.act == "sigmoid":
            return torch.sigmoid(x)
        return x

    def forward(self, st, books):
        out = self.SubMConv3d_0(st, books[(id(st.structure),
                                           self.kernel_size)])
        f, mask = out.features, out.valid_mask()
        if self.act_first:
            f = self.MaskedBatchNorm_0(self._act(f), mask=mask)
        else:
            f = self._act(self.MaskedBatchNorm_0(f, mask=mask))
        return sp.SparseTensor(structure=out.structure, features=f)


class ResContextBlock(nn.Module):
    def __init__(self, in_features, features):
        super().__init__()
        c = features
        self.AsymmConvBNAct_0 = AsymmConvBNAct(in_features, c, K13)
        self.AsymmConvBNAct_1 = AsymmConvBNAct(c, c, K31)
        self.AsymmConvBNAct_2 = AsymmConvBNAct(in_features, c, K31)
        self.AsymmConvBNAct_3 = AsymmConvBNAct(c, c, K13)

    def forward(self, st, books):
        sc = self.AsymmConvBNAct_1(self.AsymmConvBNAct_0(st, books), books)
        r = self.AsymmConvBNAct_3(self.AsymmConvBNAct_2(st, books), books)
        return sp.SparseTensor(st.structure, r.features + sc.features)


class AsymmResBlock(nn.Module):
    def __init__(self, in_features, features, height_pooling):
        super().__init__()
        c = features
        self.stride = (2, 2, 2) if height_pooling else (2, 2, 1)
        self.AsymmConvBNAct_0 = AsymmConvBNAct(in_features, c, K31)
        self.AsymmConvBNAct_1 = AsymmConvBNAct(c, c, K13)
        self.AsymmConvBNAct_2 = AsymmConvBNAct(in_features, c, K13)
        self.AsymmConvBNAct_3 = AsymmConvBNAct(c, c, K31)
        self.SparseConv3d_0 = SparseConv3d(c, c, 3)

    def forward(self, st, books, s_down):
        """-> (pooled onto ``s_down``, the pre-pooling residual)."""
        sc = self.AsymmConvBNAct_1(self.AsymmConvBNAct_0(st, books), books)
        r = self.AsymmConvBNAct_3(self.AsymmConvBNAct_2(st, books), books)
        res = sp.SparseTensor(st.structure, r.features + sc.features)
        rb, rb_inv = books[(id(st.structure), id(s_down))]
        return self.SparseConv3d_0(res, s_down, rb, rb_inv), res


class AsymmUpBlock(nn.Module):
    def __init__(self, in_features, features):
        super().__init__()
        c = features
        self.AsymmConvBNAct_0 = AsymmConvBNAct(in_features, c, K33)
        self.SparseInverseConv3d_0 = SparseInverseConv3d(c, c, 3)
        self.AsymmConvBNAct_1 = AsymmConvBNAct(c, c, K13)
        self.AsymmConvBNAct_2 = AsymmConvBNAct(c, c, K31)
        self.AsymmConvBNAct_3 = AsymmConvBNAct(c, c, K33)

    def forward(self, st, skip, books):
        s_hi = skip.structure
        up = self.AsymmConvBNAct_0(st, books)
        rb_strided, rb_inv = books[(id(s_hi), id(st.structure))]
        up = self.SparseInverseConv3d_0(up, s_hi, rb_inv, rb_strided)
        up = sp.SparseTensor(s_hi, up.features + skip.features)
        for m in (self.AsymmConvBNAct_1, self.AsymmConvBNAct_2,
                  self.AsymmConvBNAct_3):
            up = m(up, books)
        return up


class ReconBlock(nn.Module):
    """Three sigmoid-gated subm convs whose sum gates the input."""

    def __init__(self, in_features, features):
        super().__init__()
        for i, ks in enumerate(RECON):
            self.add_module(f"AsymmConvBNAct_{i}", AsymmConvBNAct(
                in_features, features, ks, act="sigmoid", act_first=False))

    def forward(self, st, books):
        gate = sum(getattr(self, f"AsymmConvBNAct_{i}")(st, books).features
                   for i in range(3))
        return sp.SparseTensor(st.structure, gate * st.features)


@BACKBONES.register_module
class Cylinder3D_Asymm_3d_spconv(nn.Module):
    return_sparse = False

    def __init__(self, output_shape=(480, 360, 32), num_input_features=16,
                 nclasses=17, n_height=32, init_size=16, use_norm=True,
                 strict=False, down_capacity_ratios=(0.6, 0.4, 0.25, 0.2)):
        super().__init__()
        self.output_shape = tuple(int(v) for v in output_shape)
        self.down_capacity_ratios = tuple(down_capacity_ratios)
        c = init_size
        self.out_channels = 4 * c  # the _v2p variant's features
        self.ResContextBlock_0 = ResContextBlock(num_input_features, c)
        heights = (True, True, False, False)
        widths = (c, 2 * c, 4 * c, 8 * c, 16 * c)
        for i in range(4):
            self.add_module(f"AsymmResBlock_{i}", AsymmResBlock(
                widths[i], widths[i + 1], heights[i]))
        ups = ((16 * c, 16 * c), (16 * c, 8 * c), (8 * c, 4 * c),
               (4 * c, 2 * c))
        for i, (cin, cout) in enumerate(ups):
            self.add_module(f"AsymmUpBlock_{i}", AsymmUpBlock(cin, cout))
        self.ReconBlock_0 = ReconBlock(2 * c, 2 * c)
        if not self.return_sparse:
            self.SubMConv3d_0 = SubMConv3d(4 * c, nclasses, 3)

    def structures(self, s1: sp.SparseStructure):
        """The five stage structures s1-s5, their tables t1-t5 (s1's
        480x360x32 grid takes a KeyTable, the others RankTables, as
        sparse.dense_table picks), and the rulebooks keyed by (id of the
        structure, kernel shape) for subm convs and (id of the finer,
        id of the coarser structure) for the strided / inverse pairs."""
        V = s1.capacity
        caps = [max(1, int(V * r)) for r in self.down_capacity_ratios]
        ss = [s1]
        strides = [blk.stride for blk in (self.AsymmResBlock_0,
                                          self.AsymmResBlock_1,
                                          self.AsymmResBlock_2,
                                          self.AsymmResBlock_3)]
        for stride, cap in zip(strides, caps):
            ss.append(sp.downsample_structure(ss[-1], stride, cap))
        ts = [sp.dense_table(s) for s in ss]
        b = {f"s{i + 1}": s for i, s in enumerate(ss)}
        b.update({f"t{i + 1}": t for i, t in enumerate(ts)})

        def subm(i, ks):
            b[(id(ss[i]), ks)] = sp.build_subm_rulebook(ss[i], ks,
                                                        table=ts[i])

        subm(0, K13)
        subm(0, K31)
        for i, stride in enumerate(strides):
            b[(id(ss[i]), id(ss[i + 1]))] = (
                sp.build_strided_rulebook(ss[i], ss[i + 1], 3, stride, 1,
                                          table=ts[i]),
                sp.build_inverse_rulebook(ss[i + 1], ss[i], 3, stride, 1,
                                          table=ts[i + 1]))
            if i < 3:
                subm(i + 1, K31)
                subm(i + 1, K13)
        for i in range(4, -1, -1):  # the up blocks' 3x3x3, deepest first
            subm(i, K33)
        for ks in RECON:
            subm(0, ks)
        return b

    def convs(self, st_in: sp.SparseTensor, b):
        x = self.ResContextBlock_0(st_in, b)
        skips = []
        for i in range(4):
            x, res = getattr(self, f"AsymmResBlock_{i}")(x, b, b[f"s{i + 2}"])
            skips.append(res)
        for i in range(4):
            x = getattr(self, f"AsymmUpBlock_{i}")(x, skips[3 - i], b)
        up0 = self.ReconBlock_0(x, b)
        feats = torch.cat([up0.features, x.features], dim=-1)
        st_out = sp.SparseTensor(x.structure, feats)
        if self.return_sparse:
            return {"sparse_features": st_out}
        logits = self.SubMConv3d_0(st_out, b[(id(x.structure), K33)])
        # densify to [B, R, P, Z, ncls]; invalid rows go to a dropped row
        R, P, Z = self.output_shape
        f = logits.features
        B, Vc, C = f.shape
        coords = logits.structure.coords.to(torch.int64)
        cell = coords[..., 0] * (P * Z) + coords[..., 1] * Z + coords[..., 2]
        offs = (torch.arange(B, device=f.device) * (R * P * Z))[:, None]
        tgt = torch.where(logits.structure.valid_mask(), cell + offs,
                          B * R * P * Z).reshape(-1)
        dense = f.new_zeros(B * R * P * Z + 1, C).index_put(
            (tgt,), f.reshape(-1, C))
        return {"bev_logits": dense[:-1].reshape(B, R, P, Z, C)}

    def forward(self, st_in: sp.SparseTensor):
        return self.convs(st_in, self.structures(st_in.structure))


@BACKBONES.register_module
class Cylinder3D_Asymm_3d_spconv_v2p(Cylinder3D_Asymm_3d_spconv):
    """The variant that returns the per-voxel sparse features (for a point
    head) instead of dense logits."""

    return_sparse = True
