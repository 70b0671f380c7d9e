"""SegPolarNet: the dynamic-VFE segmentor of the PolarNet and Cylinder3D
configs (PyTorch port of lidarseg3d_tpu/models/segmentors/seg_polarnet.py).

The reader voxelizes the points on the device: PolarNet's into a dense
BEV grid for the BEV UNet, Cylinder3D's into a sparse cylindrical voxel
set for the asymmetric sparse UNet, whose dense logits the PolarNet head
reads per point. The Cylinder3D _v2p variant feeds the sparse features to
PointSegBatchlossHead, which devoxelizes in cylindrical metric space on
the structure re-keyed in reversed (z, phi, r) order (a 32x360x480 grid:
a KeyTable), its rows re-sorted by those keys. In evaluation mode the
forward runs under ``torch.inference_mode()``; in training mode it builds
the autograd graph and draws PolarNet's DropBlock from the train state's
generator.
"""

import torch
from torch import nn

from ...ops import coords as coord_ops
from ...ops import dynamic_voxel as dv
from ...ops import sparse as sp
from .. import builder
from ..registry import DETECTORS


def rekey_reversed(s: sp.SparseStructure):
    """The structure ``s`` in reversed (z, phi, r) coordinate order over the
    reversed grid, its rows sorted by their keys there (padding rows last):
    -> (the [B, V] row order, the structure). A lookup table's rank is a
    row only in key order. The JAX package keeps ``s``'s row order, which
    is sorted by (r, phi, z) keys, and its lookups on that table then
    return other voxels' rows (ROADMAP C, reference fault 12)."""
    rc = s.coords.flip(-1)
    _, Y, X = s.spatial_shape[::-1]
    keys = (rc[..., 0] * Y + rc[..., 1]) * X + rc[..., 2]
    keys = torch.where(s.valid_mask(), keys, coord_ops.INVALID_KEY)
    order = torch.argsort(keys, dim=1, stable=True)
    return order, sp.build_structure(_rows(rc, order), s.num_voxels,
                                     s.spatial_shape[::-1])


def _rows(t, order):
    """t [B, V, ...] with each sample's rows in ``order`` [B, V]."""
    idx = order.view(*order.shape, *([1] * (t.dim() - 2))).expand_as(t)
    return torch.gather(t, 1, idx)


@DETECTORS.register_module
class SegPolarNet(nn.Module):
    def __init__(self, reader=None, backbone=None, point_head=None,
                 neck=None, bbox_head=None, pretrained=None, train_cfg=None,
                 test_cfg=None):
        super().__init__()
        self.test_cfg = test_cfg
        self.reader_mod = builder.build_reader(dict(reader))
        self.backbone_mod = builder.build_backbone(dict(backbone))
        self.polar = "PolarNet" in type(self.reader_mod).__name__
        ph = dict(point_head)
        if ph.get("type") == "PointSegBatchlossHead":
            # devoxelize on the cylindrical grid: voxel size and range in
            # (rho, phi, z) metric axes, float32 as in the JAX package
            lo = torch.tensor(reader["point_cloud_range"][:3],
                              dtype=torch.float32)
            hi = torch.tensor(reader["point_cloud_range"][3:],
                              dtype=torch.float32)
            gs = torch.tensor(reader["grid_size"], dtype=torch.float32)
            ph.setdefault("voxel_size", tuple(((hi - lo) / gs).tolist()))
            ph.setdefault("point_cloud_range",
                          tuple(lo.tolist()) + tuple(hi.tolist()))
            # the head's input width is the backbone's output; the JAX
            # package infers it, and the published config's CONV_IN_DIM
            # (128) is not what the backbone gives (64)
            ph["model_cfg"] = dict(ph.get("model_cfg") or {},
                                   CONV_IN_DIM=self.backbone_mod.out_channels)
        self.point_head_mod = builder.build_point_head(ph)

    def lidar_input(self, example):
        """The reader's output (the Cylinder3D reader's sparse tensor under
        "sparse_tensor")."""
        if self.polar:
            return self.reader_mod(example["points"], example["point_valid"])
        return self.reader_mod(example["points"], example["point_valid"],
                               example.get("point_sem_labels"))

    def forward(self, example, generator=None):
        """example: the collated points-only batch on the model's device.
        Returns (ret, batch) like the JAX package's ``apply(...,
        train=self.training)``."""
        with torch.inference_mode(not self.training):
            batch = dict(example)
            r = self.lidar_input(example)
            if self.polar:
                batch["bev_logits"] = self.backbone_mod(r["bev_features"],
                                                        generator=generator)
            else:
                out = self.backbone_mod(r["sparse_tensor"])
                if "sparse_features" in out:
                    st = out["sparse_features"]
                    order, rev = rekey_reversed(st.structure)
                    batch["conv_point_features"] = _rows(st.features, order)
                    batch["conv_structure"] = rev
                    batch["conv_table"] = sp.dense_table(rev)
                    batch["points"] = dv.cart2cylind(
                        example["points"][..., :3])
                    if "voxel_sem_labels" in r:
                        batch["voxel_sem_labels"] = _rows(
                            r["voxel_sem_labels"], order)
                        batch["voxel_valid"] = rev.valid_mask()
                else:
                    batch.update(out)
                    if "voxel_sem_labels" in r:
                        batch["voxel_sem_labels"] = r["voxel_sem_labels"]
            batch["point_vcoors"] = r["point_vcoors"]
            return self.point_head_mod(batch, generator=generator), batch

    def frozen_parameters(self):
        """No parameter of a SegPolarNet is frozen."""
        return []

    def loss(self, ret, batch):
        loss, ldict = self.point_head_mod.get_loss(ret, batch)
        ldict["loss"] = loss
        return loss, ldict

    @torch.inference_mode()
    def predict(self, ret, batch, test_cfg=None):
        return self.point_head_mod.predict(ret, batch,
                                           test_cfg or self.test_cfg)
