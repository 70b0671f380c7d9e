"""PointPillars detector (PyTorch port of
lidarseg3d_tpu/models/segmentors/point_pillars.py): PFN reader -> dense
BEV scatter -> RPN -> CenterHead on the padded [B, V, P, D] pillars; loss
and predict are VoxelNet's. No kernel of the port runs on this path (the
scatter is an index_put, the neck and head are cuDNN convs).
"""

import torch

from .. import builder
from ..registry import DETECTORS
from .voxelnet import _Detector


@DETECTORS.register_module
class PointPillars(_Detector):
    def __init__(self, reader=None, backbone=None, neck=None,
                 bbox_head=None, pretrained=None, train_cfg=None,
                 test_cfg=None, input_shape=None):
        super().__init__()
        self.reader_mod = builder.build_reader(dict(reader))
        self.backbone_mod = builder.build_backbone(dict(backbone))
        self._build_top(neck, bbox_head, self.reader_mod.out_channels,
                        test_cfg)

    def forward(self, example, generator=None):
        with torch.inference_mode(not self.training):
            feats = self.reader_mod(example["voxels"], example["num_points"],
                                    example["coordinates"])
            bev = self.backbone_mod(feats, example["coordinates"],
                                    example["num_voxels"],
                                    example["input_shape"])
            return self._top(bev, example)
