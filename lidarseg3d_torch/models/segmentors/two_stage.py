"""TwoStageDetector: two-stage CenterPoint box refinement (PyTorch port of
lidarseg3d_tpu/models/segmentors/two_stage.py): the first-stage detector's
proposals (its decode at ``NMS_POST_MAXSIZE`` rows a frame, with validity
flags) -> the BEV features at each proposal's centre, or at its 5 points
(``num_point``), concatenated per RoI in the JAX package's order -> the
RoI head's IoU score and box residuals -> boxes scored by
sqrt(sigmoid(iou) * first-stage score).

With ``freeze`` the first stage is fixed while the second trains: its BN
stays on running statistics in ``train()`` mode, it runs without autograd
(under ``torch.inference_mode``, so its backbone builds no inverse
rulebooks), its parameters get zero gradients through
``frozen_parameters()`` (the optimizer's weight decay still acts, as it
does in the JAX package on every parameter behind a ``stop_gradient``),
and the loss has the RoI head's terms only. The RoI head's input width is
the extractors' total width times ``num_point``; the config's
``input_channels`` (which the JAX package's Flax Linear ignores) is
checked against it.
"""

import warnings

import torch
from torch import nn

from ...utils.registry import build_from_cfg
from ..registry import DETECTORS, ROI_HEAD, SECOND_STAGE
from ..roi_heads.roi_head import RoIHead, assign_targets
from ..second_stage.bev_extractor import box_sample_points


@DETECTORS.register_module
class TwoStageDetector(nn.Module):
    def __init__(self, first_stage_cfg=None, second_stage_modules=(),
                 roi_head=None, NMS_POST_MAXSIZE=83, num_point=1,
                 freeze=False, train_cfg=None, test_cfg=None):
        super().__init__()
        first = dict(first_stage_cfg)
        first.pop("pretrained", None)
        first.setdefault("train_cfg", train_cfg)
        first.setdefault("test_cfg", test_cfg)
        self.single_det = build_from_cfg(first, DETECTORS)
        # parameter-free extractors: a plain list keeps them out of the
        # state_dict, as Flax's second_stage_k scopes hold no leaf
        self.second_stage = [build_from_cfg(dict(m), SECOND_STAGE)
                             for m in second_stage_modules]
        self.NMS_POST_MAXSIZE = int(NMS_POST_MAXSIZE)
        self.num_point = int(num_point)
        self.freeze = bool(freeze)
        self.test_cfg = dict(test_cfg or {})
        rh = dict(roi_head)
        width = (len(self.second_stage) * self.num_point
                 * self.single_det.neck_mod.out_channels)
        if int(rh.get("input_channels", width)) != width:
            warnings.warn(f"RoIHead input_channels={rh['input_channels']} "
                          f"but the extractors give {width} a RoI; the "
                          "head takes the extractors' width, as the JAX "
                          "package's does")
        rh["input_channels"] = width
        self.roi_head_cfg = rh
        self.roi_head_mod = build_from_cfg(rh, ROI_HEAD)

    def train(self, mode=True):
        """Training mode; a frozen first stage stays in evaluation mode."""
        super().train(mode)
        if mode and self.freeze:
            self.single_det.eval()
        return self

    def frozen_parameters(self):
        """The first stage's parameter names under ``freeze``."""
        if not self.freeze:
            return []
        return ["single_det." + n for n, _ in
                self.single_det.named_parameters()]

    def forward(self, example, generator=None):
        """-> (dict(first_stage, rois, roi_scores, roi_labels (1-based),
        roi_valid, rcnn_cls, rcnn_reg), batch) like the JAX package's
        ``apply``."""
        with torch.inference_mode(not self.training):
            rets, batch = self.single_det(example)
            out = self.refine(batch, self.proposals(rets, batch), generator)
        out["first_stage"] = rets
        return out, batch

    def proposals(self, rets, batch):
        """The first stage's decode at NMS_POST_MAXSIZE rows -> dict(rois,
        roi_scores, roi_labels (1-based), roi_valid)."""
        props = self.single_det.predict(rets, batch, dict(
            self.test_cfg, max_out=self.NMS_POST_MAXSIZE))
        # the decode ran under inference_mode: plain copies, so that
        # autograd may save them
        return {"rois": props["box3d_lidar"].clone(),
                "roi_scores": props["scores"].clone(),
                "roi_labels": props["label_preds"].clone() + 1,
                "roi_valid": props["valid"].clone()}

    def refine(self, batch, props, generator=None):
        """The second stage on the proposals: the BEV features at each
        RoI's sample points, concatenated per RoI as [point, channel], and
        the RoI head -> ``props`` with rcnn_cls and rcnn_reg."""
        centers = box_sample_points(props["rois"], self.num_point)
        feats = []
        for mod in self.second_stage:
            f = mod(batch["bev_feature"], centers)  # [B, M * np, C]
            if self.num_point > 1:
                B, MP, C = f.shape
                M = MP // self.num_point
                f = f.reshape(B, self.num_point, M, C).transpose(1, 2)
                f = f.reshape(B, M, self.num_point * C)
            feats.append(f)
        rcnn_cls, rcnn_reg = self.roi_head_mod(
            torch.cat(feats, dim=-1), props["roi_valid"], generator=generator)
        return dict(props, rcnn_cls=rcnn_cls, rcnn_reg=rcnn_reg)

    def loss(self, rets, batch):
        """The RoI head's losses on targets from ``gt_boxes_and_cls`` [B, G,
        8] (box, 1-based class; rows of zero size are padding), plus the
        first stage's unless frozen -> (total, dict with "loss")."""
        if self.freeze:
            total, ldict = 0.0, {}
        else:
            total, ldict = self.single_det.loss(rets["first_stage"], batch)
        cfg = self.roi_head_cfg.get("model_cfg") or {}
        gt = batch["gt_boxes_and_cls"]
        targets = assign_targets(
            rets["rois"].detach(), rets["roi_labels"], gt[..., :7],
            gt[..., 7].to(torch.int32), gt[..., 3] > 0,
            dict(cfg.get("TARGET_CONFIG", {})))
        roi_total, roi_ld = RoIHead.get_loss(
            rets["rcnn_cls"], rets["rcnn_reg"], targets, rets["roi_valid"],
            dict(cfg.get("LOSS_CONFIG", {})))
        total = total + roi_total
        ldict = dict(ldict)
        ldict.update(roi_ld)
        ldict["loss"] = total
        return total, ldict

    @torch.inference_mode()
    def predict(self, rets, batch, test_cfg=None):
        """IoU-rectified boxes -> dict(box3d_lidar [B, M, 7], scores,
        label_preds (0-based), valid); no velocity."""
        boxes = RoIHead.generate_predicted_boxes(rets["rois"],
                                                 rets["rcnn_reg"])
        iou = torch.sigmoid(rets["rcnn_cls"][..., 0])
        scores = torch.sqrt((iou * rets["roi_scores"]).clamp(min=0.0))
        return {"box3d_lidar": boxes,
                "scores": torch.where(rets["roi_valid"], scores,
                                      torch.zeros_like(scores)),
                "label_preds": rets["roi_labels"] - 1,
                "valid": rets["roi_valid"]}
