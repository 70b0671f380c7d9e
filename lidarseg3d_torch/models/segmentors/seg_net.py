"""SegNet: the LiDAR-only segmentor, reader -> sparse UNet -> point head
(PyTorch port of lidarseg3d_tpu/models/segmentors/seg_net.py). SDSeg3D
(TransVFE + the batch-loss head) and the MSeg3D papers' lidar-only
baselines (ImprovedMeanVFE + the batch-loss head) are SegNets. In
evaluation mode the forward runs under ``torch.inference_mode()``; in
training mode it builds the autograd graph.
"""

import torch
from torch import nn

from ...ops import sparse as sp
from ...utils.spans import span
from .. import builder
from ..registry import DETECTORS


@DETECTORS.register_module
class SegNet(nn.Module):
    def __init__(self, reader=None, backbone=None, point_head=None,
                 neck=None, pretrained=None, train_cfg=None, test_cfg=None):
        super().__init__()
        self.test_cfg = test_cfg
        self.reader_mod = builder.build_reader(dict(reader))
        self.backbone_mod = builder.build_backbone(dict(backbone))
        # the head devoxelizes on the backbone's grid
        ph = dict(point_head)
        ph.setdefault("voxel_size", tuple(backbone.get("voxel_size")))
        ph.setdefault("point_cloud_range",
                      tuple(backbone.get("point_cloud_range")))
        self.point_head_mod = builder.build_point_head(ph)

    def lidar_input(self, example):
        """VFE features on the input structure."""
        with span("reader"):
            feats = self.reader_mod(example["voxels"], example["num_points"],
                                    example["coordinates"])
        with span("rulebooks"):
            struct = sp.build_structure(example["coordinates"],
                                        example["num_voxels"],
                                        example["input_shape"])
        return sp.SparseTensor(structure=struct, features=feats)

    def forward(self, example, generator=None):
        """example: the collated batch on the model's device (see
        synthetic.example_to_device). Returns (ret, batch) like the JAX
        package's ``apply(..., train=self.training)``."""
        with torch.inference_mode(not self.training):
            batch = dict(example)
            batch.update(self.backbone_mod(self.lidar_input(example)))
            with span("head"):
                ret = self.point_head_mod(batch, generator=generator)
            return ret, batch

    def frozen_parameters(self):
        """No parameter of a SegNet is frozen."""
        return []

    def loss(self, ret, batch):
        with span("head"):
            loss, ldict = self.point_head_mod.get_loss(ret, batch)
            ldict["loss"] = loss
            return loss, ldict

    @torch.inference_mode()
    def predict(self, ret, batch, test_cfg=None):
        with span("head"):
            return self.point_head_mod.predict(ret, batch,
                                               test_cfg or self.test_cfg)
