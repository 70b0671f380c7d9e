"""FCN decode head of MSeg3D's camera branch (PyTorch port of
lidarseg3d_tpu/models/img_heads/fcn_mseg3d_head.py:33 FCNMSeg3DHead).

Resize-concat of the HRNet pyramid, num_convs 3x3 ConvBNReLUs, a 1x1
classifier, and the camera semantic embeddings. Works in NCHW and returns
the JAX package's NHWC layout.
"""

import torch
from torch import nn

from ...ops.resize import resize_bilinear
from ..img_backbones.hrnet import ConvBNReLU
from ..layers import Scopes, add
from ..registry import IMG_HEADS


def camera_semantic_embeddings(feats, logits, batch_size):
    """feats/logits: [B*ncam, h, w, C/ncls] -> [B, ncls, C]: softmax over
    all pixels of all cameras of a frame, then the prob-weighted sum."""
    BN, h, w, C = feats.shape
    ncam = BN // batch_size
    f = feats.reshape(batch_size, ncam * h * w, C)
    p = torch.softmax(logits.reshape(batch_size, ncam * h * w, -1), dim=1)
    return torch.einsum("bpc,bpe->bce", p, f)


@IMG_HEADS.register_module
class FCNMSeg3DHead(nn.Module):
    def __init__(self, in_channels=(18, 36, 72, 144), in_index=(0, 1, 2, 3),
                 channels=48, num_convs=2, kernel_size=3, concat_input=True,
                 num_classes=20, ignore_index=0, loss_weight=1.0,
                 lovasz_loss_weight=-1.0, dropout_ratio=-1.0,
                 input_transform="resize_concat", align_corners=False,
                 norm_cfg=None, use_sc_conv=False, conv_seg_kernel=1,
                 compute_dtype=None):
        super().__init__()
        if use_sc_conv or compute_dtype is not None \
                or input_transform != "resize_concat":
            raise NotImplementedError(
                "the port has the resize-concat fp32 FCN head only")
        s = Scopes()
        self.in_index = tuple(in_index)
        cin = sum(in_channels[i] for i in self.in_index)
        self.convs = []
        c = cin
        for _ in range(num_convs):
            self.convs.append(add(self, s, ConvBNReLU(c, channels,
                                                      kernel=kernel_size)))
            c = channels
        self.concat = []
        if concat_input:
            self.concat.append(add(self, s, ConvBNReLU(
                cin + channels, channels, kernel=kernel_size)))
        self.Conv_0 = nn.Conv2d(channels, num_classes, conv_seg_kernel,
                                padding=conv_seg_kernel // 2)

    def forward(self, inputs, batch_size):
        """inputs: list of NCHW HRNet maps [B*ncam, C_i, h_i, w_i].
        Returns image_features [B*ncam, h, w, channels], image_logits
        [B*ncam, h, w, ncls] (NHWC) and camera_semantic_embeddings
        [B, ncls, channels]."""
        tgt = inputs[self.in_index[0]]
        ups = [tgt] + [resize_bilinear(inputs[i], tgt.shape[-2:])
                       for i in self.in_index[1:]]
        x = torch.cat(ups, dim=1)
        feats = x
        for m in self.convs:
            feats = m(feats)
        if self.concat:
            feats = self.concat[0](torch.cat([x, feats], dim=1))
        logits = self.Conv_0(feats)
        feats = feats.permute(0, 2, 3, 1).contiguous()
        logits = logits.permute(0, 2, 3, 1).contiguous()
        return {
            "image_features": feats,
            "image_logits": logits,
            "camera_semantic_embeddings": camera_semantic_embeddings(
                feats, logits, batch_size),
        }
