"""FCN decode head of MSeg3D's camera branch (PyTorch port of
lidarseg3d_tpu/models/img_heads/fcn_mseg3d_head.py:33 FCNMSeg3DHead).

Resize-concat of the HRNet pyramid, num_convs 3x3 ConvBNReLUs (with
``use_sc_conv``, SCBottlenecks after the first: sc_conv.py), a 1x1
classifier, and the camera semantic embeddings. Works in NCHW and returns
the JAX package's NHWC layout. With ``compute_dtype`` ("bfloat16") the
inputs are cast and the convs run in that type; the three outputs are
always fp32, as in the JAX package. ``get_loss`` is the pixel CE (and
optional Lovász) against point-painted labels at the image resolution.
"""

import torch
from torch import nn

from ...ops import losses as L
from ...ops.resize import resize_bilinear
from ..img_backbones.hrnet import ConvBNReLU, conv_as_input
from ..layers import Scopes, add
from ..registry import IMG_HEADS
from .sc_conv import SCBottleneck


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
        if input_transform != "resize_concat":
            raise NotImplementedError(
                "FCNMSeg3DHead resize-concats its inputs (the JAX package's "
                "head has no other input transform)")
        self.compute_dtype = (None if compute_dtype is None
                              else getattr(torch, compute_dtype))
        self.ignore_index = ignore_index
        self.loss_weight = loss_weight
        self.lovasz_loss_weight = lovasz_loss_weight
        s = Scopes()
        self.in_index = tuple(in_index)
        cin = sum(in_channels[i] for i in self.in_index)
        self.convs = []
        c = cin
        for i in range(num_convs):
            self.convs.append(add(self, s, SCBottleneck(c, channels)
                                  if use_sc_conv and i > 0 else
                                  ConvBNReLU(c, channels,
                                             kernel=kernel_size)))
            c = channels
        self.concat = []
        if concat_input:
            self.concat.append(add(self, s, ConvBNReLU(
                cin + c, channels, kernel=kernel_size)))
            c = channels
        self.Conv_0 = nn.Conv2d(c, num_classes, conv_seg_kernel,
                                padding=conv_seg_kernel // 2)

    def decode(self, inputs, generator=None):
        """The decode body: resize-concat, the conv stack, the concat of
        the input, ``dropout`` (none here), the classifier. -> features
        and logits, NHWC, fp32 (float64 for a float64 input)."""
        if self.compute_dtype is not None:
            inputs = [x.to(self.compute_dtype) for x in inputs]
        tgt = inputs[self.in_index[0]]
        ups = [tgt] + [resize_bilinear(inputs[i], tgt.shape[-2:])
                       for i in self.in_index[1:]]
        x = torch.cat(ups, dim=1)
        feats = x
        for m in self.convs:
            feats = m(feats)
        if self.concat:
            feats = self.concat[0](torch.cat([x, feats], dim=1))
        feats = self.dropout(feats, generator)
        logits = conv_as_input(self.Conv_0, feats)
        out_t = torch.promote_types(feats.dtype, torch.float32)
        return (feats.permute(0, 2, 3, 1).to(out_t).contiguous(),
                logits.permute(0, 2, 3, 1).to(out_t).contiguous())

    def dropout(self, feats, generator):
        return feats

    def forward(self, inputs, batch_size):
        """inputs: list of NCHW HRNet maps [B*ncam, C_i, h_i, w_i].
        Returns image_features [B*ncam, h, w, channels], image_logits
        [B*ncam, h, w, ncls] (NHWC) and camera_semantic_embeddings
        [B, ncls, channels]."""
        feats, logits = self.decode(inputs)
        return {
            "image_features": feats,
            "image_logits": logits,
            "camera_semantic_embeddings": camera_semantic_embeddings(
                feats, logits, batch_size),
        }

    def get_loss(self, ret, batch):
        """Pixel CE on sparse point-painted labels: the logits are
        upsampled to the labels' resolution. batch["images_sem_labels"]:
        [B*ncam, H, W] int, ``ignore_index`` where unlabeled."""
        labels = batch["images_sem_labels"]
        logits = resize_bilinear(ret["image_logits"].permute(0, 3, 1, 2),
                                 labels.shape[-2:]).permute(0, 2, 3, 1)
        flat_logits = logits.reshape(-1, logits.shape[-1])
        flat_labels = labels.reshape(-1)
        ce = self.loss_weight * L.cross_entropy(flat_logits, flat_labels,
                                                self.ignore_index)
        loss, ldict = ce, {"image_ce_loss": ce}
        if self.lovasz_loss_weight > 0:
            lvsz = self.lovasz_loss_weight * L.lovasz_softmax(
                torch.softmax(flat_logits, -1), flat_labels,
                ignore=self.ignore_index)
            loss = loss + lvsz
            ldict["image_lvsz_loss"] = lvsz
        return loss, ldict
