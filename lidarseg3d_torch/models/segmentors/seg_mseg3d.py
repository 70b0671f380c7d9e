"""SegMSeg3DNet: LiDAR + multi-camera segmentor (PyTorch port of
lidarseg3d_tpu/models/segmentors/seg_mseg3d.py:18, inference forward).

The forward runs under ``torch.inference_mode()``: camera branch (HRNet ->
FCN head with semantic embeddings), lidar branch (VFE -> structures and
rulebooks -> sparse UNet convs), then the fusion point head. The three
stages are separate methods so a caller can time them.
"""

import torch
from torch import nn

from ...ops import sparse as sp
from .. import builder
from ..registry import DETECTORS


@DETECTORS.register_module
class SegMSeg3DNet(nn.Module):
    def __init__(self, reader=None, backbone=None, point_head=None,
                 img_backbone=None, img_head=None, neck=None,
                 pretrained=None, train_cfg=None, test_cfg=None):
        super().__init__()
        self.test_cfg = test_cfg
        self.reader_mod = builder.build_reader(dict(reader))
        self.backbone_mod = builder.build_backbone(dict(backbone))
        ph = dict(point_head)
        ph.setdefault("voxel_size", tuple(backbone.get("voxel_size")))
        ph.setdefault("point_cloud_range",
                      tuple(backbone.get("point_cloud_range")))
        self.point_head_mod = builder.build_point_head(ph)
        self.img_backbone_mod = builder.build_img_backbone(dict(img_backbone))
        self.img_head_mod = builder.build_img_head(dict(img_head))

    def image_branch(self, example):
        """images [B, ncam, H, W, 3] -> FCN head outputs (NHWC)."""
        images = example["images"]
        B, ncam = images.shape[:2]
        imgs = images.reshape(B * ncam, *images.shape[2:]).permute(0, 3, 1, 2)
        return self.img_head_mod(self.img_backbone_mod(imgs), batch_size=B)

    def lidar_input(self, example):
        """VFE features on the input structure."""
        feats = self.reader_mod(example["voxels"], example["num_points"],
                                example["coordinates"])
        struct = sp.build_structure(example["coordinates"],
                                    example["num_voxels"],
                                    example["input_shape"])
        return sp.SparseTensor(structure=struct, features=feats)

    def head(self, example, bb_out, img_out):
        batch = dict(example)
        batch.update(bb_out)
        batch.update(img_out)
        ret = self.point_head_mod(batch)
        ret["image_logits"] = img_out["image_logits"]
        return ret, batch

    @torch.inference_mode()
    def forward(self, example):
        """example: the collated batch on the model's device (see
        synthetic.example_to_device). Returns (ret, batch) like the JAX
        package's ``apply(..., train=False)``."""
        img_out = self.image_branch(example)
        bb_out = self.backbone_mod(self.lidar_input(example))
        return self.head(example, bb_out, img_out)

    @torch.inference_mode()
    def predict(self, ret, batch, test_cfg=None):
        return self.point_head_mod.predict(ret, batch,
                                           test_cfg or self.test_cfg)
