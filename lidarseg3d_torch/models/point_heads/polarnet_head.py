"""PolarNet point head (PyTorch port of
lidarseg3d_tpu/models/point_heads/polarnet_head.py PointSegPolarNetHead):
each point's logits are gathered from the dense [B, R, P, Z, C] grid at
its (clamped) cylindrical voxel; the loss is point-level CE + Lovász."""

import torch
from torch import nn

from ...ops import losses as L
from ..registry import POINT_HEADS


@POINT_HEADS.register_module
class PointSegPolarNetHead(nn.Module):
    def __init__(self, class_agnostic=False, num_class=17, model_cfg=None):
        super().__init__()
        self.n_cls = 1 if class_agnostic else num_class
        self.ignored_label = dict(model_cfg or {}).get("IGNORED_LABEL", 0)

    def forward(self, batch, generator=None):
        """batch: bev_logits [B, R, P, Z, C], point_vcoors [B, N, 3]
        (r, phi, z) -> dict(out_logits [B, N, C]). The head draws nothing
        at random; ``generator`` is accepted for the segmentors' common
        call."""
        logits = batch["bev_logits"]
        B, R, P, Z, C = logits.shape
        vc = batch["point_vcoors"].to(torch.int64)
        idx = (torch.arange(B, device=vc.device)[:, None] * (R * P * Z)
               + vc[..., 0] * (P * Z) + vc[..., 1] * Z + vc[..., 2])
        flat = logits.reshape(B * R * P * Z, C)
        return {"out_logits": flat[idx.reshape(-1)].reshape(B, -1, C)}

    def get_loss(self, ret, batch):
        logits = ret["out_logits"].reshape(-1, self.n_cls)
        labels = batch["point_sem_labels"].reshape(-1)
        valid = batch["point_valid"].reshape(-1)
        ce = L.cross_entropy(logits, labels, self.ignored_label, valid=valid)
        lvsz = L.lovasz_softmax(torch.softmax(logits, -1), labels,
                                ignore=self.ignored_label, valid=valid)
        return ce + lvsz, {"out_ce_loss": ce, "out_lvsz_loss": lvsz}

    @staticmethod
    def predict(ret, batch, test_cfg=None):
        logits = ret["out_logits"]
        return {"pred_point_sem_labels": torch.argmax(logits, dim=-1),
                "point_valid": batch["point_valid"],
                "point_softmax": torch.softmax(logits, dim=-1)}
