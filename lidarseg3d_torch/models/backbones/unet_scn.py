"""Sparse-conv UNet backbone (PyTorch port of
lidarseg3d_tpu/models/backbones/unet_scn.py:25 UNetSCN3D).

Residual encoder of four stride-2 stages, UR-block decoder with inverse
convs back onto the stored structures, BN eps=1e-3 throughout. All
structures, rank tables and rulebooks are built once per forward
(``structures``) and shared by the convs (``convs``), spconv's indice_key
semantics.
"""

import torch
from torch import nn

from ...ops import sparse as sp
from ..registry import BACKBONES
from ..sparse_modules import (SparseBasicBlock, SparseBasicBlockStack,
                              SparseConvBNReLU)


@BACKBONES.register_module
class UNetSCN3D(nn.Module):
    def __init__(self, num_input_features=16, ds_factor=8, us_factor=8,
                 point_cloud_range=(), voxel_size=(), model_cfg=None):
        super().__init__()
        cfg = dict(model_cfg or {})
        if cfg.get("RETURN_ENCODED_TENSOR", False):
            raise NotImplementedError(
                "the detection encoded tensor is not ported")
        self.point_cloud_range = tuple(point_cloud_range)
        self.voxel_size = tuple(voxel_size)
        self.caps = cfg.get("DOWN_CAPACITY_RATIOS", (0.5, 0.25, 0.15))
        self.sites = cfg.get("OUTPUT_SITES", "decimation")
        r = cfg.get("SCALING_RATIO", 1)
        c1, c2, c3 = 16 * r, 32 * r, 64 * r
        cbr = SparseConvBNReLU
        # names follow the JAX package's Flax scopes (see models/layers.py)
        self.SparseConvBNReLU_0 = cbr(num_input_features, c1)  # conv_input
        self.SparseBasicBlockStack_0 = SparseBasicBlockStack(c1)
        self.SparseConvBNReLU_1 = cbr(c1, c2, conv_type="spconv")
        self.SparseBasicBlockStack_1 = SparseBasicBlockStack(c2)
        self.SparseConvBNReLU_2 = cbr(c2, c3, conv_type="spconv")
        self.SparseBasicBlockStack_2 = SparseBasicBlockStack(c3)
        self.SparseConvBNReLU_3 = cbr(c3, c3, conv_type="spconv")
        self.SparseBasicBlockStack_3 = SparseBasicBlockStack(c3)
        # decoder: per UR block a lateral residual block, a subm conv of the
        # concat, and the inverse conv (the last stage's is a subm conv)
        self.SparseBasicBlock_0 = SparseBasicBlock(c3)
        self.SparseConvBNReLU_4 = cbr(2 * c3, c3)
        self.SparseConvBNReLU_5 = cbr(c3, c3, conv_type="inverseconv")
        self.SparseBasicBlock_1 = SparseBasicBlock(c3)
        self.SparseConvBNReLU_6 = cbr(2 * c3, c3)
        self.SparseConvBNReLU_7 = cbr(c3, c2, conv_type="inverseconv")
        self.SparseBasicBlock_2 = SparseBasicBlock(c2)
        self.SparseConvBNReLU_8 = cbr(2 * c2, c2)
        self.SparseConvBNReLU_9 = cbr(c2, c1, conv_type="inverseconv")
        self.SparseBasicBlock_3 = SparseBasicBlock(c1)
        self.SparseConvBNReLU_10 = cbr(2 * c1, c1)
        self.SparseConvBNReLU_11 = cbr(c1, c1)

    def structures(self, s1: sp.SparseStructure):
        """Stage structures, rank tables and the 10 rulebooks (4 subm,
        3 strided, 3 inverse)."""
        V = s1.capacity
        caps, sites = self.caps, self.sites
        down = sp.downsample_structure
        t1 = sp.dense_table(s1)
        b = dict(s1=s1, t1=t1, subm1=sp.build_subm_rulebook(s1, table=t1))
        s2 = down(s1, 2, capacity=max(1, int(V * caps[0])), padding=1,
                  rule=sites)
        b["down2"] = sp.build_strided_rulebook(s1, s2, 3, 2, 1, table=t1)
        t2 = sp.dense_table(s2)
        b["subm2"] = sp.build_subm_rulebook(s2, table=t2)
        b["inv2"] = sp.build_inverse_rulebook(s2, s1, 3, 2, 1, table=t2)
        s3 = down(s2, 2, capacity=max(1, int(V * caps[1])), padding=1,
                  rule=sites)
        t3 = sp.dense_table(s3)
        b["down3"] = sp.build_strided_rulebook(s2, s3, 3, 2, 1, table=t2)
        b["subm3"] = sp.build_subm_rulebook(s3, table=t3)
        b["inv3"] = sp.build_inverse_rulebook(s3, s2, 3, 2, 1, table=t3)
        s4 = down(s3, 2, capacity=max(1, int(V * caps[2])),
                  padding=(0, 1, 1), rule=sites)
        t4 = sp.dense_table(s4)
        b["down4"] = sp.build_strided_rulebook(s3, s4, 3, 2, (0, 1, 1),
                                               table=t3)
        b["subm4"] = sp.build_subm_rulebook(s4, table=t4)
        b["inv4"] = sp.build_inverse_rulebook(s4, s3, 3, 2, (0, 1, 1),
                                              table=t4)
        b.update(s2=s2, s3=s3, s4=s4)
        return b

    def convs(self, st_in: sp.SparseTensor, b):
        """The 36 sparse convs on the prebuilt rulebooks ``b``."""
        x = self.SparseConvBNReLU_0(st_in, b["subm1"])
        x_conv1 = self.SparseBasicBlockStack_0(x, b["subm1"])
        x = self.SparseConvBNReLU_1(x_conv1, b["down2"], out_struct=b["s2"])
        x_conv2 = self.SparseBasicBlockStack_1(x, b["subm2"])
        x = self.SparseConvBNReLU_2(x_conv2, b["down3"], out_struct=b["s3"])
        x_conv3 = self.SparseBasicBlockStack_2(x, b["subm3"])
        x = self.SparseConvBNReLU_3(x_conv3, b["down4"], out_struct=b["s4"])
        x_conv4 = self.SparseBasicBlockStack_3(x, b["subm4"])

        def ur_block(x_lateral, x_bottom, rb_lat, lat_block, mid):
            x_trans = lat_block(x_lateral, rb_lat)
            cat = torch.cat([x_bottom.features, x_trans.features], dim=-1)
            x_m = mid(sp.SparseTensor(x_lateral.structure, cat), rb_lat)
            c_mid = x_m.features.shape[-1]
            red = cat.reshape(*cat.shape[:2], c_mid, -1).sum(dim=-1)
            return sp.SparseTensor(x_lateral.structure, x_m.features + red)

        f = ur_block(x_conv4, x_conv4, b["subm4"], self.SparseBasicBlock_0,
                     self.SparseConvBNReLU_4)
        x_up4 = self.SparseConvBNReLU_5(f, b["inv4"], out_struct=b["s3"])
        f = ur_block(x_conv3, x_up4, b["subm3"], self.SparseBasicBlock_1,
                     self.SparseConvBNReLU_6)
        x_up3 = self.SparseConvBNReLU_7(f, b["inv3"], out_struct=b["s2"])
        f = ur_block(x_conv2, x_up3, b["subm2"], self.SparseBasicBlock_2,
                     self.SparseConvBNReLU_8)
        x_up2 = self.SparseConvBNReLU_9(f, b["inv2"], out_struct=b["s1"])
        f = ur_block(x_conv1, x_up2, b["subm1"], self.SparseBasicBlock_3,
                     self.SparseConvBNReLU_10)
        x_up1 = self.SparseConvBNReLU_11(f, b["subm1"])
        return dict(
            conv_point_features=x_up1.features,  # [B, V, 16r]
            conv_point_coords=sp.voxel_centers(
                b["s1"], self.voxel_size, self.point_cloud_range),
            conv_structure=b["s1"],
            conv_table=b["t1"],
            # stride-1 subm rulebook, reused by the point head's
            # devoxelization (ops/interpolate.py _grid_interp_rulebook)
            conv_subm_rulebook=b["subm1"],
            multi_scale_3d_features={"x_conv1": x_up2, "x_conv2": x_up3,
                                     "x_conv3": x_up4, "x_conv4": x_conv4},
        )

    def forward(self, st_in: sp.SparseTensor):
        return self.convs(st_in, self.structures(st_in.structure))
