"""Sparse-conv UNet backbone (PyTorch port of
lidarseg3d_tpu/models/backbones/unet_scn.py:25 UNetSCN3D).

Residual encoder of four stride-2 stages, UR-block decoder with inverse
convs back onto the stored structures, BN eps=1e-3 throughout. All
structures, lookup tables and rulebooks are built once per forward
(``structures``) and shared by the convs (``convs``), spconv's indice_key
semantics.
"""

import torch
from torch import nn

from . import sparse as sp
from .sparse_modules import (SparseBasicBlock, SparseBasicBlockStack,
                              SparseConvBNReLU)


class UNetSCN3D(nn.Module):
    def __init__(self, num_input_features=16, ds_factor=8, us_factor=8,
                 point_cloud_range=(), voxel_size=(), model_cfg=None):
        super().__init__()
        cfg = dict(model_cfg or {})
        # the detection-only encoded tensor: an extra (3, 1, 1) conv of
        # stride (2, 1, 1) on stage 4 (JAX unet_scn.py RETURN_ENCODED_TENSOR)
        self.encoded = bool(cfg.get("RETURN_ENCODED_TENSOR", False))
        self.last_pad = cfg.get("last_pad", 0)
        self.point_cloud_range = tuple(point_cloud_range)
        self.voxel_size = tuple(voxel_size)
        self.caps = cfg.get("DOWN_CAPACITY_RATIOS", (0.5, 0.25, 0.15))
        self.sites = cfg.get("OUTPUT_SITES", "decimation")
        r = cfg.get("SCALING_RATIO", 1)
        c1, c2, c3 = 16 * r, 32 * r, 64 * r
        cbr = SparseConvBNReLU
        # ACT_REMAT recomputes the encoder's residual blocks in the backward
        rm = bool(cfg.get("ACT_REMAT", False))
        # names follow the JAX package's Flax scopes (see models/layers.py)
        self.SparseConvBNReLU_0 = cbr(num_input_features, c1)  # conv_input
        self.SparseBasicBlockStack_0 = SparseBasicBlockStack(c1, remat=rm)
        self.SparseConvBNReLU_1 = cbr(c1, c2, conv_type="spconv")
        self.SparseBasicBlockStack_1 = SparseBasicBlockStack(c2, remat=rm)
        self.SparseConvBNReLU_2 = cbr(c2, c3, conv_type="spconv")
        self.SparseBasicBlockStack_2 = SparseBasicBlockStack(c3, remat=rm)
        self.SparseConvBNReLU_3 = cbr(c3, c3, conv_type="spconv")
        self.SparseBasicBlockStack_3 = SparseBasicBlockStack(c3, remat=rm)
        e = 0
        if self.encoded:  # Flax creates it before the decoder's convs
            self.SparseConvBNReLU_4 = cbr(c3, 128, kernel_size=(3, 1, 1),
                                          conv_type="spconv")
            e = 1
        # decoder: per UR block a lateral residual block, a subm conv of the
        # concat, and the inverse conv (the last stage's is a subm conv);
        # its convs are SparseConvBNReLU_{4+e} .. _{11+e}, in self.dec
        self.dec = []
        for i, (c_lat, c_out) in enumerate(((c3, c3), (c3, c2), (c2, c1),
                                            (c1, c1))):
            setattr(self, f"SparseBasicBlock_{i}", SparseBasicBlock(c_lat))
            for j, (cin, c, kind) in enumerate((
                    (2 * c_lat, c_lat, "subm"),
                    (c_lat, c_out, "inverseconv" if i < 3 else "subm"))):
                m = cbr(cin, c, conv_type=kind)
                setattr(self, f"SparseConvBNReLU_{4 + e + 2 * i + j}", m)
                self.dec.append(m)

    def structures(self, s1: sp.SparseStructure):
        """Stage structures s1-s4, their lookup tables t1-t4 (RankTables or
        KeyTables, as sparse.dense_table picks) and the 10 rulebooks
        (4 subm, 3 strided, 3 inverse); with RETURN_ENCODED_TENSOR also
        the extra conv's structure and strided rulebook (and, when
        gradients are recorded, its inverse)."""
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
        b.update(s2=s2, s3=s3, s4=s4, t2=t2, t3=t3, t4=t4)
        if self.encoded:
            enc = dict(kernel_size=(3, 1, 1), stride=(2, 1, 1),
                       padding=self.last_pad)
            b["s_enc"] = down(s4, (2, 1, 1), capacity=s4.capacity)
            b["down_enc"] = sp.build_strided_rulebook(s4, b["s_enc"],
                                                      table=t4, **enc)
            if torch.is_grad_enabled():  # only the conv's backward reads it
                b["inv_enc"] = sp.build_inverse_rulebook(b["s_enc"], s4,
                                                         **enc)
        return b

    def convs(self, st_in: sp.SparseTensor, b):
        """The 36 sparse convs on the prebuilt rulebooks ``b``. Strided and
        inverse convs get each other's rulebook as the transposed one their
        backward needs."""
        x = self.SparseConvBNReLU_0(st_in, b["subm1"])
        x_conv1 = self.SparseBasicBlockStack_0(x, b["subm1"])
        x = self.SparseConvBNReLU_1(x_conv1, b["down2"], out_struct=b["s2"],
                                    rulebook_t=b["inv2"])
        x_conv2 = self.SparseBasicBlockStack_1(x, b["subm2"])
        x = self.SparseConvBNReLU_2(x_conv2, b["down3"], out_struct=b["s3"],
                                    rulebook_t=b["inv3"])
        x_conv3 = self.SparseBasicBlockStack_2(x, b["subm3"])
        x = self.SparseConvBNReLU_3(x_conv3, b["down4"], out_struct=b["s4"],
                                    rulebook_t=b["inv4"])
        x_conv4 = self.SparseBasicBlockStack_3(x, b["subm4"])
        out = {}
        if self.encoded:
            out["encoded_spconv_tensor"] = self.SparseConvBNReLU_4(
                x_conv4, b["down_enc"], out_struct=b["s_enc"],
                rulebook_t=b.get("inv_enc"))
            out["encoded_spconv_tensor_stride"] = 8
        dec = self.dec

        def ur_block(x_lateral, x_bottom, rb_lat, lat_block, mid):
            x_trans = lat_block(x_lateral, rb_lat)
            cat = torch.cat([x_bottom.features, x_trans.features], dim=-1)
            x_m = mid(sp.SparseTensor(x_lateral.structure, cat), rb_lat)
            c_mid = x_m.features.shape[-1]
            red = cat.reshape(*cat.shape[:2], c_mid, -1).sum(dim=-1)
            return sp.SparseTensor(x_lateral.structure, x_m.features + red)

        f = ur_block(x_conv4, x_conv4, b["subm4"], self.SparseBasicBlock_0,
                     dec[0])
        x_up4 = dec[1](f, b["inv4"], out_struct=b["s3"],
                       rulebook_t=b["down4"])
        f = ur_block(x_conv3, x_up4, b["subm3"], self.SparseBasicBlock_1,
                     dec[2])
        x_up3 = dec[3](f, b["inv3"], out_struct=b["s2"],
                       rulebook_t=b["down3"])
        f = ur_block(x_conv2, x_up3, b["subm2"], self.SparseBasicBlock_2,
                     dec[4])
        x_up2 = dec[5](f, b["inv2"], out_struct=b["s1"],
                       rulebook_t=b["down2"])
        f = ur_block(x_conv1, x_up2, b["subm1"], self.SparseBasicBlock_3,
                     dec[6])
        x_up1 = dec[7](f, b["subm1"])
        return dict(
            out,
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

