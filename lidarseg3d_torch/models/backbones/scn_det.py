"""Detection middle encoder SpMiddleResNetFHD (PyTorch port of
lidarseg3d_tpu/models/backbones/scn_det.py): a subm input conv and two
residual blocks at 16 channels, three stride-2 stages (32 / 64 / 128, the
last padded (0, 1, 1)), an extra (3, 1, 1) conv of stride (2, 1, 1) and
padding 0, then the BEV map [B, Z' * 128, Y', X'] (NCHW; channel z * 128
+ c, the JAX package's NHWC [B, Y', X', Z' * C] order).

Every conv runs on the rulebook stack (ops/sparse.py): the fused conv
kernel, and rulebooks from the rank-table kernel or the KeyTable merge,
as ``table_kind`` picks for each stage's grid. The inverse rulebooks of
the strided convs serve only their backward (dX under the transposed
rulebook), so they are built only when gradients are recorded; the JAX
package builds them always and XLA drops them from an inference program.
"""

import torch
from torch import nn

from ...ops import sparse as sp
from ..registry import BACKBONES
from ..sparse_modules import SparseBasicBlock, SparseConvBNReLU

# (stride, padding) of the three stride-2 stages and of the extra conv
DOWN_STAGES = ((2, 1), (2, 1), (2, (0, 1, 1)))
EXTRA = dict(kernel_size=(3, 1, 1), stride=(2, 1, 1), padding=0)


def out_depth(depth):
    """Z' of the BEV map for an input grid of ``depth`` slabs: four ceil
    halvings (the decimation rule's output shape)."""
    for _ in range(4):
        depth = -(-depth // 2)
    return depth


@BACKBONES.register_module
class SpMiddleResNetFHD(nn.Module):
    def __init__(self, num_input_features=5, norm_cfg=None, ds_factor=8,
                 down_capacity_ratios=(0.5, 0.25, 0.15, 0.15)):
        super().__init__()
        self.caps = tuple(down_capacity_ratios)
        cbr = SparseConvBNReLU
        # names follow the JAX package's Flax scopes (models/layers.py)
        self.SparseConvBNReLU_0 = cbr(num_input_features, 16)
        self.SparseBasicBlock_0 = SparseBasicBlock(16)
        self.SparseBasicBlock_1 = SparseBasicBlock(16)
        for i, (cin, c) in enumerate(((16, 32), (32, 64), (64, 128))):
            setattr(self, f"SparseConvBNReLU_{i + 1}",
                    cbr(cin, c, conv_type="spconv"))
            setattr(self, f"SparseBasicBlock_{2 * i + 2}",
                    SparseBasicBlock(c))
            setattr(self, f"SparseBasicBlock_{2 * i + 3}",
                    SparseBasicBlock(c))
        self.SparseConvBNReLU_4 = cbr(128, 128, kernel_size=(3, 1, 1),
                                      conv_type="spconv")

    @staticmethod
    def bev_channels(input_shape):
        """Channels of the BEV map for the (Z, Y, X) input grid."""
        return 128 * out_depth(int(input_shape[0]))

    def structures(self, s1: sp.SparseStructure, transposed=None):
        """Stage structures s1-s5, lookup tables t1-t4 (RankTables or
        KeyTables, as sparse.dense_table picks) and the rulebooks: subm1-4,
        down2-4 and the extra conv's down5; with ``transposed`` (default:
        when gradients are recorded) the inverse rulebooks inv2-inv5 too."""
        if transposed is None:
            transposed = torch.is_grad_enabled()
        V = s1.capacity
        t1 = sp.dense_table(s1)
        b = dict(s1=s1, t1=t1, subm1=sp.build_subm_rulebook(s1, table=t1))
        s, t = s1, t1
        for i, (stride, pad) in enumerate(DOWN_STAGES):
            n = i + 2
            s_out = sp.downsample_structure(s, stride,
                                            max(1, int(V * self.caps[i])))
            b[f"down{n}"] = sp.build_strided_rulebook(s, s_out, 3, stride,
                                                      pad, table=t)
            t_out = sp.dense_table(s_out)
            if transposed:
                b[f"inv{n}"] = sp.build_inverse_rulebook(
                    s_out, s, 3, stride, pad, table=t_out)
            b[f"subm{n}"] = sp.build_subm_rulebook(s_out, table=t_out)
            b[f"s{n}"], b[f"t{n}"] = s_out, t_out
            s, t = s_out, t_out
        s5 = sp.downsample_structure(s, EXTRA["stride"],
                                     max(1, int(V * self.caps[3])))
        b["down5"] = sp.build_strided_rulebook(s, s5, table=t, **EXTRA)
        if transposed:
            b["inv5"] = sp.build_inverse_rulebook(s5, s, **EXTRA)
        b["s5"] = s5
        return b

    def convs(self, st_in: sp.SparseTensor, b):
        """The 21 sparse convs on the prebuilt rulebooks ``b`` -> the
        extra conv's sparse output (on s5)."""
        x = self.SparseConvBNReLU_0(st_in, b["subm1"])
        x = self.SparseBasicBlock_1(self.SparseBasicBlock_0(x, b["subm1"]),
                                    b["subm1"])
        for n in (2, 3, 4):
            i = n - 1
            x = getattr(self, f"SparseConvBNReLU_{i}")(
                x, b[f"down{n}"], out_struct=b[f"s{n}"],
                rulebook_t=b.get(f"inv{n}"))
            for j in (2 * i, 2 * i + 1):
                x = getattr(self, f"SparseBasicBlock_{j}")(x, b[f"subm{n}"])
        return self.SparseConvBNReLU_4(x, b["down5"], out_struct=b["s5"],
                                       rulebook_t=b.get("inv5"))

    @staticmethod
    def densify(x: sp.SparseTensor):
        """Sparse [B, V, C] on (Z, Y, X) -> the BEV map [B, Z * C, Y, X]."""
        s = x.structure
        Z, Y, X = s.spatial_shape
        B, _, C = x.features.shape
        c = s.coords.to(torch.int64)
        cell = (c[..., 0] * Y + c[..., 1]) * X + c[..., 2]
        offs = torch.arange(B, device=cell.device)[:, None] * (Z * Y * X)
        tgt = torch.where(s.valid_mask(), cell + offs, B * Z * Y * X)
        dense = x.features.new_zeros(B * Z * Y * X + 1, C).index_put(
            (tgt.reshape(-1),), x.features.reshape(-1, C))
        dense = dense[:-1].view(B, Z, Y, X, C)
        return dense.permute(0, 1, 4, 2, 3).reshape(B, Z * C, Y, X)

    def forward(self, st_in: sp.SparseTensor):
        return self.densify(self.convs(st_in, self.structures(
            st_in.structure)))
