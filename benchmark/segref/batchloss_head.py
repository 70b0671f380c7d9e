"""SDSeg3D point head with the batch-wise loss (PyTorch port of
lidarseg3d_tpu/models/point_heads/batchloss_head.py PointSegBatchlossHead):
a voxel classifier MLP, 3-NN devoxelization of the voxel features to the
points, an align layer (linear, BN with eps 1e-6, ReLU) and the point
classifier MLP; the loss is CE + Lovász at voxel and at point level.
Submodule names follow the JAX head's Flax scopes (models/layers.py).
"""

import torch
import torch.nn.functional as F
from torch import nn

from . import interpolate as interp
from . import losses as L
from .layers import MaskedBatchNorm, MLPHead, TorchLinear


class PointSegBatchlossHead(nn.Module):
    def __init__(self, class_agnostic=False, num_class=20, model_cfg=None,
                 voxel_size=(), point_cloud_range=()):
        super().__init__()
        cfg = dict(model_cfg or {})
        self.ignored_label = cfg.get("IGNORED_LABEL", 0)
        self.n_cls = n_cls = 1 if class_agnostic else num_class
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        c_in, align = cfg["CONV_IN_DIM"], cfg["CONV_ALIGN_DIM"]
        self.MLPHead_0 = MLPHead(c_in, tuple(cfg["CONV_CLS_FC"]), n_cls)
        self.TorchLinear_0 = TorchLinear(c_in, align)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(align, eps=1e-6)
        self.MLPHead_1 = MLPHead(align, tuple(cfg["OUT_CLS_FC"]), n_cls)

    def forward(self, batch, generator=None):
        """batch: conv_point_features [B,V,C], conv_structure, conv_table,
        conv_subm_rulebook (optional), points [B,N,D], point_valid [B,N]
        -> dict(
        conv_logits [B,V,n_cls], out_logits [B,N,n_cls]). The head draws
        nothing at random; ``generator`` is accepted for the segmentors'
        common call."""
        feats = batch["conv_point_features"]
        struct = batch["conv_structure"]
        pvalid = batch["point_valid"]
        conv_logits = self.MLPHead_0(feats, mask=struct.valid_mask())
        point_feats = interp.grid_three_interpolate(
            batch["points"][..., :3], pvalid, struct, feats, self.voxel_size,
            self.point_cloud_range, table=batch["conv_table"],
            subm_rulebook=batch.get("conv_subm_rulebook"))
        x = F.relu(self.MaskedBatchNorm_0(self.TorchLinear_0(point_feats),
                                          mask=pvalid))
        return {"conv_logits": conv_logits,
                "out_logits": self.MLPHead_1(x, mask=pvalid)}

    def get_loss(self, ret, batch):
        """CE + Lovász on the valid voxels and on the valid points ->
        (loss, dict of the four terms)."""
        ignored, n_cls = self.ignored_label, self.n_cls

        def terms(logits, labels, valid):
            logits = logits.reshape(-1, n_cls)
            labels, valid = labels.reshape(-1), valid.reshape(-1)
            return (L.cross_entropy(logits, labels, ignored, valid=valid),
                    L.lovasz_softmax(torch.softmax(logits, -1), labels,
                                     ignore=ignored, valid=valid))

        conv_ce, conv_lvsz = terms(ret["conv_logits"],
                                   batch["voxel_sem_labels"],
                                   batch["voxel_valid"])
        out_ce, out_lvsz = terms(ret["out_logits"], batch["point_sem_labels"],
                                 batch["point_valid"])
        loss = conv_ce + conv_lvsz + out_ce + out_lvsz
        return loss, {"conv_ce_loss": conv_ce, "conv_lovasz_loss": conv_lvsz,
                      "out_ce_loss": out_ce, "out_lovasz_loss": out_lvsz}

    @staticmethod
    def predict(ret, batch, test_cfg=None):
        """Point labels and softmax; a frame's TTA variants are merged
        over batch rows by apis.eval.run_eval."""
        logits = ret["out_logits"]
        return {"pred_point_sem_labels": torch.argmax(logits, dim=-1),
                "point_valid": batch["point_valid"],
                "point_softmax": torch.softmax(logits, dim=-1)}
