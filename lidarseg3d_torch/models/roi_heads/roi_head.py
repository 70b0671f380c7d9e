"""Second-stage RoI head of two-stage CenterPoint (PyTorch port of
lidarseg3d_tpu/models/roi_heads/roi_head.py): a shared MLP over each RoI's
feature vector, then an IoU-score (cls) and a box-residual (reg) branch;
the decode of the residuals in each RoI's canonical frame; the target
assignment (each RoI's best same-class gt by 3-D IoU, its residual in the
RoI's frame with the opposite heading flipped, IoU-interpolated score
labels); the losses.

As in the JAX package, every one of the NMS_POST_MAXSIZE RoI rows is kept
(no fg/bg subsampling): the losses average over the valid rows (score)
and the valid foreground rows (residuals).

The Linear / BN layers carry Flax's compact names in call order: shared
``TorchLinear_0, MaskedBatchNorm_0, ...``, then the cls branch, then the
reg branch, each branch ending in a Linear with bias. The first Linear's
input width is what the extractor gives the head (``input_channels``).
Dropout (``DP_RATIO``, after every shared layer but the last and after
every branch layer) draws its mask from the train state's generator, over
the global batch in a multi-process run.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import box_ops
from ...parallel import dist
from ..layers import MaskedBatchNorm, Scopes, TorchLinear, add
from ..registry import ROI_HEAD


def encode_gt_of_rois(rois, gt_boxes):
    """gt boxes -> each RoI's canonical frame: the centre offset rotated
    by -ry, the dims' residual, the heading's residual wrapped into
    [-pi, pi) and flipped into [-pi/2, pi/2]."""
    ct = gt_boxes[..., :3] - rois[..., :3]
    ry = rois[..., 6]
    ct = box_ops.rotate_points_along_z(ct, -ry)
    dims = gt_boxes[..., 3:6] - rois[..., 3:6]
    rel = gt_boxes[..., 6] - ry
    rel = torch.remainder(rel + math.pi, 2 * math.pi) - math.pi
    flip = rel.abs() > math.pi / 2
    rel = torch.where(flip, rel - torch.sign(rel) * math.pi, rel)
    return torch.cat([ct, dims, rel[..., None]], dim=-1)


def assign_targets(rois, roi_labels, gt_boxes, gt_classes, gt_valid, cfg):
    """Per-RoI targets. rois [B, N, 7]; roi_labels [B, N] (1-based);
    gt_boxes [B, G, 7]; gt_classes [B, G] (1-based); gt_valid [B, G] ->
    dict(gt_of_rois [B, N, 7], reg_fg [B, N] bool, cls_labels [B, N])."""
    fg_thresh = cfg.get("REG_FG_THRESH", 0.55)
    cls_fg = cfg.get("CLS_FG_THRESH", 0.75)
    cls_bg = cfg.get("CLS_BG_THRESH", 0.25)
    matched, best_iou = [], []
    for b in range(rois.shape[0]):
        iou = box_ops.boxes_iou_3d(rois[b], gt_boxes[b])  # [N, G]
        ok = (roi_labels[b][:, None] == gt_classes[b][None, :]) \
            & gt_valid[b][None, :]
        iou = torch.where(ok, iou, torch.full_like(iou, -1.0))
        best = iou.argmax(dim=1)  # the first best among ties
        matched.append(gt_boxes[b][best])
        best_iou.append(iou.max(dim=1).values.clamp(min=0.0))
    matched, max_iou = torch.stack(matched), torch.stack(best_iou)
    return dict(gt_of_rois=encode_gt_of_rois(rois, matched),
                reg_fg=max_iou > fg_thresh,
                cls_labels=((max_iou - cls_bg) / (cls_fg - cls_bg)).clamp(
                    0.0, 1.0))


@ROI_HEAD.register_module
class RoIHead(nn.Module):
    def __init__(self, input_channels=0, model_cfg=None, num_class=1,
                 code_size=7, test_cfg=None):
        super().__init__()
        cfg = dict(model_cfg or {})
        self.model_cfg = cfg
        self.dp = float(cfg.get("DP_RATIO", 0.3))
        s = Scopes()

        def layers(c, fcs):
            out = []
            for f in fcs:
                out.append((add(self, s, TorchLinear(c, f, bias=False)),
                            add(self, s, MaskedBatchNorm(f, eps=1e-5,
                                                         momentum=0.1))))
                c = f
            return out, c

        # plain lists: the layers are registered under their Flax names
        self.shared, c = layers(int(input_channels),
                                list(cfg.get("SHARED_FC", (256, 256))))
        cls, cc = layers(c, list(cfg.get("CLS_FC", (256, 256))))
        self.cls = [cls, add(self, s, TorchLinear(cc, num_class))]
        reg, cr = layers(c, list(cfg.get("REG_FC", (256, 256))))
        self.reg = [reg, add(self, s, TorchLinear(cr, code_size))]

    def _dropout(self, x, generator):
        if not (self.training and self.dp > 0):
            return x
        if generator is None:
            raise ValueError("training with DP_RATIO > 0 needs an explicit "
                             "torch.Generator")
        # the global batch's mask, from a generator identical on every
        # rank: each rank keeps its rows (parallel/dist.py)
        draw = torch.rand((x.shape[0] * dist.world_size(), *x.shape[1:]),
                          generator=generator, device=x.device,
                          dtype=torch.float32)
        keep = dist.local_rows(draw) >= self.dp
        return x * keep / (1.0 - self.dp)

    def forward(self, roi_features, roi_valid, generator=None):
        """roi_features [B, N, C]; roi_valid [B, N] bool -> (rcnn_cls
        [B, N, num_class], rcnn_reg [B, N, code_size])."""
        x = roi_features
        for i, (lin, bn) in enumerate(self.shared):
            x = F.relu(bn(lin(x), mask=roi_valid))
            if i != len(self.shared) - 1:
                x = self._dropout(x, generator)

        def branch(x, layers, out):
            for lin, bn in layers:
                x = self._dropout(F.relu(bn(lin(x), mask=roi_valid)),
                                  generator)
            return out(x)

        return branch(x, *self.cls), branch(x, *self.reg)

    @staticmethod
    def generate_predicted_boxes(rois, rcnn_reg):
        """Decode the canonical-frame residuals: rotate(reg + [0, 0, 0,
        roi dims, roi ry], roi ry) + roi centre."""
        local = torch.cat([torch.zeros_like(rois[..., :3]), rois[..., 3:]],
                          dim=-1)
        pred = rcnn_reg + local
        xyz = box_ops.rotate_points_along_z(pred[..., :3], rois[..., 6])
        return torch.cat([xyz + rois[..., :3], pred[..., 3:]], dim=-1)

    @staticmethod
    def get_loss(rcnn_cls, rcnn_reg, targets, roi_valid, cfg=None):
        """Binary cross-entropy of the IoU score over the valid rows and the
        code-weighted L1 of the residuals over the valid foreground rows ->
        (total, {"rcnn_loss_cls", "rcnn_loss_reg"})."""
        w = dict(cfg or {}).get("LOSS_WEIGHTS", {
            "rcnn_cls_weight": 1.0, "rcnn_reg_weight": 1.0,
            "code_weights": [1.0] * 7})
        labels = targets["cls_labels"].reshape(-1)
        valid = roi_valid.reshape(-1).to(rcnn_cls.dtype)
        p = torch.sigmoid(rcnn_cls.reshape(-1))
        bce = -(labels * torch.log(p.clamp(1e-7, 1.0))
                + (1 - labels) * torch.log((1 - p).clamp(1e-7, 1.0)))
        cls_loss = (bce * valid).sum() / valid.sum().clamp(min=1.0)
        code_w = torch.as_tensor(w.get("code_weights", [1.0] * 7),
                                 dtype=rcnn_reg.dtype, device=rcnn_reg.device)
        reg = rcnn_reg.reshape(-1, rcnn_reg.shape[-1])
        tgt = targets["gt_of_rois"].reshape(-1, reg.shape[-1])
        fg = (targets["reg_fg"].reshape(-1)
              & roi_valid.reshape(-1)).to(reg.dtype)
        l1 = (reg - tgt).abs() * code_w[None, :]
        reg_loss = (l1.sum(-1) * fg).sum() / fg.sum().clamp(min=1.0)
        cls_loss = cls_loss * w.get("rcnn_cls_weight", 1.0)
        reg_loss = reg_loss * w.get("rcnn_reg_weight", 1.0)
        return cls_loss + reg_loss, {"rcnn_loss_cls": cls_loss,
                                     "rcnn_loss_reg": reg_loss}
