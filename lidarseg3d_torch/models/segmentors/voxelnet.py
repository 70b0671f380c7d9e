"""VoxelNet: the single-stage CenterPoint detector (PyTorch port of
lidarseg3d_tpu/models/segmentors/voxelnet.py): VFE reader ->
SpMiddleResNetFHD -> RPN -> CenterHead, the targets assigned on the host
(core/center_targets.py). In evaluation mode the forward runs under
``torch.inference_mode()``; in training mode it builds the autograd graph.

The RPN's input width is the backbone's BEV width for the voxel grid
``input_shape`` (Z, Y, X) the model is built for (the tools pass their
``input_shape_of`` the config), not the neck's ``num_input_features``,
which the JAX package's ``nn.Conv`` ignores.
"""

import torch
from torch import nn

from ...ops import sparse as sp
from .. import builder
from ..bbox_heads.center_head import CenterHead
from ..registry import DETECTORS


class _Detector(nn.Module):
    """Neck, head, loss and predict shared by VoxelNet and PointPillars
    (the reference's BaseDetector)."""

    def _build_top(self, neck, bbox_head, bev_channels, test_cfg):
        self.test_cfg = test_cfg
        self.bbox_head_cfg = dict(bbox_head)
        self.neck_mod = builder.build_neck(dict(neck,
                                                in_channels=bev_channels))
        self.head_mod = builder.build_head(dict(
            bbox_head, in_channels=self.neck_mod.out_channels))

    def _top(self, bev, example):
        feats = self.neck_mod(bev)
        rets = self.head_mod(feats)
        batch = dict(example)
        batch["bev_feature"] = feats  # the second stage's BEV map
        return rets, batch

    def frozen_parameters(self):
        """No parameter of a detector is frozen."""
        return []

    def loss(self, rets, batch):
        total, ldict = self.head_mod.get_loss(rets, batch["det_targets"])
        ldict["loss"] = total
        return total, ldict

    @torch.inference_mode()
    def predict(self, rets, batch, test_cfg=None):
        """Decode each task, then merge the tasks with global class
        offsets -> dict(box3d_lidar [B, T * max_out, 7], scores,
        label_preds, valid [, velocity]) and the per-task list "tasks".
        The decode's top-K is 100 for every config (the JAX package passes
        no ``k``), so slots past 100 per task are never valid."""
        cfg = dict(test_cfg or self.test_cfg or {})
        outs = CenterHead.decode(
            rets, voxel_size=cfg.get("voxel_size", (0.1, 0.1)),
            pc_range=cfg.get("pc_range", (-75.2, -75.2)),
            out_factor=cfg.get("out_size_factor", 8),
            score_threshold=cfg.get("score_threshold", 0.1),
            nms_iou=cfg.get("nms_iou_threshold", 0.5),
            max_out=cfg.get("max_out", 83),
            nms_type="circle" if cfg.get("circular_nms") else "rotated",
            min_radius=cfg.get("min_radius"),
            double_flip=bool(cfg.get("double_flip", False)))
        offsets, off = [], 0
        for t in self.bbox_head_cfg.get("tasks", [{}] * len(outs)):
            offsets.append(off)
            off += int(t.get("num_class", 1)) if isinstance(t, dict) else 1
        merged = {
            "box3d_lidar": torch.cat([o["box3d"] for o in outs], 1),
            "scores": torch.cat([o["scores"] for o in outs], 1),
            "label_preds": torch.cat(
                [o["labels"] + offs for o, offs in zip(outs, offsets)], 1),
            "valid": torch.cat([o["valid"] for o in outs], 1),
            "tasks": outs,
        }
        if all("velocity" in o for o in outs):
            merged["velocity"] = torch.cat([o["velocity"] for o in outs], 1)
        return merged


@DETECTORS.register_module
class VoxelNet(_Detector):
    def __init__(self, reader=None, backbone=None, neck=None,
                 bbox_head=None, pretrained=None, train_cfg=None,
                 test_cfg=None, input_shape=None):
        super().__init__()
        self.reader_mod = builder.build_reader(dict(reader))
        self.backbone_mod = builder.build_backbone(dict(backbone))
        if input_shape is None:
            raise ValueError("VoxelNet needs the voxel grid input_shape "
                             "(Z, Y, X) to size its neck")
        self._build_top(neck, bbox_head,
                        self.backbone_mod.bev_channels(input_shape),
                        test_cfg)

    def forward(self, example, generator=None):
        """example: the collated batch on the model's device. Returns
        (per-task maps, batch) like the JAX package's ``apply``."""
        with torch.inference_mode(not self.training):
            feats = self.reader_mod(example["voxels"], example["num_points"],
                                    example["coordinates"])
            struct = sp.build_structure(example["coordinates"],
                                        example["num_voxels"],
                                        example["input_shape"])
            bev = self.backbone_mod(sp.SparseTensor(structure=struct,
                                                    features=feats))
            return self._top(bev, example)
