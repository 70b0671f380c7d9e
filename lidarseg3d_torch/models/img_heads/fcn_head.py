"""Plain FCN decode head (PyTorch port of
lidarseg3d_tpu/models/img_heads/fcn_head.py:18 FCNHead), for image-only
segmentation experiments: FCNMSeg3DHead's decode body (resize-concat of
the pyramid, or one input, the ConvBNReLU stack, the concat of the input,
the 1x1 classifier, the pixel CE) without the camera embeddings, with
mmseg's defaults and a dropout before the classifier.
"""

import torch

from ..registry import IMG_HEADS
from .fcn_mseg3d_head import FCNMSeg3DHead


@IMG_HEADS.register_module
class FCNHead(FCNMSeg3DHead):
    def __init__(self, in_channels=(18, 36, 72, 144), in_index=(0, 1, 2, 3),
                 channels=270, num_convs=1, kernel_size=1,
                 concat_input=False, num_classes=19, dropout_ratio=-1.0,
                 input_transform="resize_concat", align_corners=False,
                 ignore_index=0, loss_weight=1.0, norm_cfg=None,
                 loss_decode=None):
        if input_transform != "resize_concat":
            # one input: the resize-concat of that map alone
            in_index = (in_index if isinstance(in_index, int)
                        else in_index[0],)
        super().__init__(in_channels=in_channels, in_index=in_index,
                         channels=channels, num_convs=num_convs,
                         kernel_size=kernel_size, concat_input=concat_input,
                         num_classes=num_classes, ignore_index=ignore_index,
                         loss_weight=loss_weight)
        self.dropout_ratio = dropout_ratio

    def dropout(self, feats, generator):
        """In training mode with ``dropout_ratio > 0``: a dropout drawn
        from ``generator``."""
        if not (self.dropout_ratio > 0 and self.training):
            return feats
        keep = 1.0 - self.dropout_ratio
        mask = torch.rand(feats.shape, generator=generator,
                          device=feats.device) < keep
        return torch.where(mask, feats / keep, torch.zeros_like(feats))

    def forward(self, inputs, batch_size=None, generator=None):
        """inputs: list of NCHW maps. -> image_features [N, h, w, C] and
        image_logits [N, h, w, ncls] (NHWC, fp32)."""
        feats, logits = self.decode(inputs, generator)
        return {"image_features": feats, "image_logits": logits}
