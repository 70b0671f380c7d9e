"""The two segmentors the benchmark's configurations name: SegMSeg3DNet
(LiDAR + cameras) and SegNet (LiDAR only), frozen copies of the port's
``models/segmentors/seg_mseg3d.py`` and ``seg_net.py``.

Camera branch (HRNet -> FCN head with semantic embeddings), lidar branch
(VFE -> structures and rulebooks -> sparse UNet convs), then the fusion
point head; the total loss is the point losses plus the image losses. The
three stages are separate methods so a caller can time them. In evaluation
mode the forward runs under ``torch.inference_mode()``; in training mode
it builds the autograd graph.
"""

import torch
from torch import nn

from . import sparse as sp
from .builder import build


class SegMSeg3DNet(nn.Module):
    def __init__(self, reader=None, backbone=None, point_head=None,
                 img_backbone=None, img_head=None, neck=None,
                 pretrained=None, train_cfg=None, test_cfg=None):
        super().__init__()
        self.test_cfg = test_cfg
        self.reader_mod = build(dict(reader))
        self.backbone_mod = build(dict(backbone))
        ph = dict(point_head)
        ph.setdefault("voxel_size", tuple(backbone.get("voxel_size")))
        ph.setdefault("point_cloud_range",
                      tuple(backbone.get("point_cloud_range")))
        self.point_head_mod = build(ph)
        self.img_backbone_mod = build(dict(img_backbone))
        self.img_head_mod = build(dict(img_head))

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

    def head(self, example, bb_out, img_out, generator=None):
        batch = dict(example)
        batch.update(bb_out)
        batch.update(img_out)
        ret = self.point_head_mod(batch, generator=generator)
        ret["image_logits"] = img_out["image_logits"]
        return ret, batch

    def forward(self, example, generator=None):
        """example: the collated batch on the model's device (see
        synthetic.example_to_device). Returns (ret, batch) like the JAX
        package's ``apply(..., train=self.training)``; ``generator`` feeds
        the point head's training-mode dropout."""
        with torch.inference_mode(not self.training):
            img_out = self.image_branch(example)
            bb_out = self.backbone_mod(self.lidar_input(example))
            return self.head(example, bb_out, img_out, generator)

    def frozen_parameters(self):
        """Names of the parameters that get no gradient by design: those of
        the image backbone's frozen stages."""
        return ["img_backbone_mod." + n
                for n in self.img_backbone_mod.frozen_parameters()]

    def loss(self, ret, batch):
        """Point-head losses + image-head losses -> (total, dict of every
        term and "loss")."""
        point_loss, ldict = self.point_head_mod.get_loss(ret, batch)
        img_loss, img_ldict = self.img_head_mod.get_loss(ret, batch)
        ldict.update(img_ldict)
        total = point_loss + img_loss
        ldict["loss"] = total
        return total, ldict

    @torch.inference_mode()
    def predict(self, ret, batch, test_cfg=None):
        return self.point_head_mod.predict(ret, batch,
                                           test_cfg or self.test_cfg)


class SegNet(nn.Module):
    def __init__(self, reader=None, backbone=None, point_head=None,
                 neck=None, pretrained=None, train_cfg=None, test_cfg=None):
        super().__init__()
        self.test_cfg = test_cfg
        self.reader_mod = build(dict(reader))
        self.backbone_mod = build(dict(backbone))
        # the head devoxelizes on the backbone's grid
        ph = dict(point_head)
        ph.setdefault("voxel_size", tuple(backbone.get("voxel_size")))
        ph.setdefault("point_cloud_range",
                      tuple(backbone.get("point_cloud_range")))
        self.point_head_mod = build(ph)

    def lidar_input(self, example):
        """VFE features on the input structure."""
        feats = self.reader_mod(example["voxels"], example["num_points"],
                                example["coordinates"])
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
            return self.point_head_mod(batch, generator=generator), batch

    def frozen_parameters(self):
        """No parameter of a SegNet is frozen."""
        return []

    def loss(self, ret, batch):
        loss, ldict = self.point_head_mod.get_loss(ret, batch)
        ldict["loss"] = loss
        return loss, ldict

    @torch.inference_mode()
    def predict(self, ret, batch, test_cfg=None):
        return self.point_head_mod.predict(ret, batch,
                                           test_cfg or self.test_cfg)
