"""MSeg3D multimodal fusion point head (PyTorch port of
lidarseg3d_tpu/models/point_heads/mseg3d_head.py:123 PointSegMSeg3DHead).
In training mode the voxel features pass a dropout drawn from an explicit
``torch.Generator`` and every BN takes masked batch statistics;
``get_loss`` gives the five point-head losses. In a multi-process run the
dropout mask, the statistics and the losses are the global batch's
(parallel/dist.py).

Voxel aux classifier, 3-NN devoxelization, camera features by bilinear
point-to-pixel sampling, cross-modal completion (mimic MLP), GF-Phase
fusion, and the SF-Phase decoder of points attending to the camera and
LiDAR semantic embeddings. Submodule names follow the JAX package's Flax
scopes (models/layers.py); the SFFM's nn.scan becomes the ModuleList
``SFFMDecoderLayer_0.{i}``.
"""

import torch
import torch.nn.functional as F
from torch import nn

from . import grid_sample as gs
from . import interpolate as interp
from . import losses as L
from . import dist
from . import remat
from .layers import MaskedBatchNorm, MLPHead, TorchLinear


def lidar_semantic_embeddings(feats, logits, valid):
    """feats [B,V,C], logits [B,V,ncls], valid [B,V] -> [B, ncls, C]:
    per-class softmax over the valid voxels, then prob-weighted sums."""
    neg = torch.finfo(logits.dtype).min
    masked = torch.where(valid[..., None], logits, neg)
    probs = torch.softmax(masked, dim=1)
    return torch.einsum("bvc,bve->bce", probs, feats)


def _attend(q, k, v, n_head):
    """q [B,N,E], k/v [B,M,E] -> [B,N,E]: softmax(q k^T / sqrt(dh)) v per
    head, written with plain matmuls."""
    B, N, E = q.shape
    M = k.shape[1]
    dh = E // n_head
    q = q.reshape(B, N, n_head, dh).transpose(1, 2)
    k = k.reshape(B, M, n_head, dh).transpose(1, 2)
    v = v.reshape(B, M, n_head, dh).transpose(1, 2)
    att = torch.softmax(q @ k.transpose(-1, -2) * dh ** -0.5, dim=-1)
    return (att @ v).transpose(1, 2).reshape(B, N, E)


class MultiHeadDotProductAttention(nn.Module):
    """flax.linen.MultiHeadDotProductAttention (self-attention over the
    semantic embeddings); query/key/value/out are the Flax DenseGenerals."""

    def __init__(self, d_model, n_head):
        super().__init__()
        self.n_head = n_head
        self.query = nn.Linear(d_model, d_model)
        self.key = nn.Linear(d_model, d_model)
        self.value = nn.Linear(d_model, d_model)
        self.out = nn.Linear(d_model, d_model)

    def forward(self, x):
        return self.out(_attend(self.query(x), self.key(x), self.value(x),
                                self.n_head))


class BatchedPointCrossAttention(nn.Module):
    """Points attend to their frame's 2*num_cls semantic embeddings."""

    def __init__(self, d_model, n_head):
        super().__init__()
        self.n_head = n_head
        self.TorchLinear_0 = TorchLinear(d_model, d_model)  # query
        self.TorchLinear_1 = TorchLinear(d_model, d_model)  # key
        self.TorchLinear_2 = TorchLinear(d_model, d_model)  # value
        self.TorchLinear_3 = TorchLinear(d_model, d_model)  # out

    def forward(self, query, key, value):
        return self.TorchLinear_3(_attend(
            self.TorchLinear_0(query), self.TorchLinear_1(key),
            self.TorchLinear_2(value), self.n_head))


class SFFMDecoderLayer(nn.Module):
    """Post-norm decoder layer, dropout 0, LayerNorm eps 1e-5."""

    def __init__(self, d_model, n_head, n_ffn):
        super().__init__()
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(
            d_model, n_head)
        self.LayerNorm_0 = nn.LayerNorm(d_model, eps=1e-5)
        self.BatchedPointCrossAttention_0 = BatchedPointCrossAttention(
            d_model, n_head)
        self.LayerNorm_1 = nn.LayerNorm(d_model, eps=1e-5)
        self.TorchLinear_0 = TorchLinear(n_ffn, d_model)  # FFN out
        self.TorchLinear_1 = TorchLinear(d_model, n_ffn)  # FFN in
        self.LayerNorm_2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, tgt, memory):
        memory = self.LayerNorm_0(
            memory + self.MultiHeadDotProductAttention_0(memory))
        tgt = self.LayerNorm_1(
            tgt + self.BatchedPointCrossAttention_0(tgt, memory, memory))
        t2 = self.TorchLinear_0(F.relu(self.TorchLinear_1(tgt)))
        return self.LayerNorm_2(tgt + t2), memory


class SemanticFeatureFusionModule(nn.Module):
    """With ``remat`` each decoder layer is recomputed in the backward (the
    JAX package's nn.remat of the scan body, ACT_REMAT)."""

    def __init__(self, d_input_point, d_camera_emb, d_lidar_emb, d_model=96,
                 n_head=4, n_layer=6, n_ffn=192, remat=False):
        super().__init__()
        self.remat = remat
        self.TorchLinear_0 = TorchLinear(d_input_point, d_model)
        self.TorchLinear_1 = TorchLinear(d_camera_emb, d_model)
        self.TorchLinear_2 = TorchLinear(d_lidar_emb, d_model)
        self.SFFMDecoderLayer_0 = nn.ModuleList(
            SFFMDecoderLayer(d_model, n_head, n_ffn) for _ in range(n_layer))
        self.LayerNorm_0 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, point_features, sem_emb_camera, sem_emb_lidar):
        """point_features [B,N,Cp]; sem_emb_* [B, ncls, C*] -> [B,N,d]."""
        tgt = self.TorchLinear_0(point_features)
        memory = torch.cat([self.TorchLinear_1(sem_emb_camera),
                            self.TorchLinear_2(sem_emb_lidar)], dim=1)
        for layer in self.SFFMDecoderLayer_0:
            tgt, memory = (remat.remat(layer, tgt, memory) if self.remat
                           else layer(tgt, memory))
        return self.LayerNorm_0(tgt)


class PointSegMSeg3DHead(nn.Module):
    def __init__(self, class_agnostic=False, num_class=20, model_cfg=None,
                 voxel_size=(), point_cloud_range=()):
        super().__init__()
        cfg = dict(model_cfg or {})
        # what out-of-view points carry downstream: "pseudo_camera", the
        # mimicked features (the MSeg3D paper), or "zero" (the released
        # code: zeros, the mimic MLP serving its loss only)
        self.oov = cfg.get("OOV_COMPLETION", "pseudo_camera")
        if self.oov not in ("pseudo_camera", "zero"):
            raise NotImplementedError(f"OOV_COMPLETION {self.oov!r}")
        self.dp_ratio = float(cfg.get("DP_RATIO", 0))
        self.ignored_label = cfg.get("IGNORED_LABEL", 0)
        self.n_cls = n_cls = 1 if class_agnostic else num_class
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        c_vox, c_img = cfg["VOXEL_IN_DIM"], cfg["IMAGE_IN_DIM"]
        a_vox, a_img = cfg["VOXEL_ALIGN_DIM"], cfg["IMAGE_ALIGN_DIM"]
        geo = cfg["GEO_FUSED_DIM"]
        sf = cfg["SFPhase_CFG"]
        self.MLPHead_0 = MLPHead(c_vox, tuple(cfg["VOXEL_CLS_FC"]), n_cls)
        self.TorchLinear_0 = TorchLinear(c_vox, a_vox)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(a_vox, eps=1e-6)
        self.TorchLinear_1 = TorchLinear(c_img, a_img)
        self.MaskedBatchNorm_1 = MaskedBatchNorm(a_img, eps=1e-6)
        self.MLPHead_1 = MLPHead(a_vox, tuple(cfg["MIMIC_FC"]), a_img)
        self.TorchLinear_2 = TorchLinear(a_vox + a_img, geo)
        self.MaskedBatchNorm_2 = MaskedBatchNorm(geo)
        self.SemanticFeatureFusionModule_0 = SemanticFeatureFusionModule(
            geo, c_img, c_vox, d_model=sf["d_model"], n_head=sf["n_head"],
            n_layer=sf["n_layer"], n_ffn=sf["n_ffn"],
            remat=bool(cfg.get("ACT_REMAT", False)))
        self.TorchLinear_3 = TorchLinear(sf["d_model"], num_class)

    def forward(self, batch, generator=None):
        """``generator``: the torch.Generator (on the features' device)
        the training-mode dropout draws from; unused in evaluation."""
        feats = batch["conv_point_features"]  # [B, V, C_vox]
        struct = batch["conv_structure"]
        vmask = struct.valid_mask()
        pvalid = batch["point_valid"]

        # voxel aux head (+ dropout)
        x = feats
        if self.training and self.dp_ratio > 0:
            if generator is None:
                raise ValueError("training with DP_RATIO > 0 needs an "
                                 "explicit torch.Generator")
            if remat.phase() is not None:
                # a recompute would draw another mask from the generator
                raise RuntimeError("the point head's dropout must stay "
                                   "outside every recomputed region")
            # the global batch's mask, from a generator identical on every
            # rank: each rank keeps its rows (parallel/dist.py); drawn in
            # fp32 whatever the features' dtype
            draw = torch.rand((x.shape[0] * dist.world_size(),
                               *x.shape[1:]), generator=generator,
                              device=x.device, dtype=torch.float32)
            keep = dist.local_rows(draw) >= self.dp_ratio
            x = x * keep / (1.0 - self.dp_ratio)
        voxel_logits = self.MLPHead_0(x, mask=vmask)

        # devoxelization -> point lidar features
        p_lidar0 = interp.grid_three_interpolate(
            batch["points"][..., :3], pvalid, struct, feats, self.voxel_size,
            self.point_cloud_range, table=batch["conv_table"],
            subm_rulebook=batch["conv_subm_rulebook"])
        p_lidar = F.relu(self.MaskedBatchNorm_0(self.TorchLinear_0(p_lidar0),
                                                mask=pvalid))

        # camera features at in-view points
        points_cuv = batch["points_cuv"]
        in_view = (points_cuv[..., 0] > 0.5) & pvalid
        img_feats = batch["image_features"]  # [B*ncam, h, w, C]
        B = feats.shape[0]
        img5 = img_feats.reshape(B, img_feats.shape[0] // B,
                                 *img_feats.shape[1:])
        p_cam0 = gs.sample_points_cuv(img5, points_cuv)
        p_cam = F.relu(self.MaskedBatchNorm_1(self.TorchLinear_1(p_cam0),
                                              mask=in_view))

        # cross-modal completion: out-of-view points carry the pseudo-camera
        # features (the MSeg3D paper's completion)
        p_pcam = self.MLPHead_1(p_lidar, mask=in_view)
        if self.oov == "zero":
            p_ccam = torch.where(in_view[..., None], p_cam, 0.0)
        else:
            p_ccam = torch.where(in_view[..., None], p_cam, p_pcam)
        p_ccam = p_ccam * pvalid[..., None]

        # GF-Phase
        geo = self.TorchLinear_2(torch.cat([p_lidar, p_ccam], dim=-1))
        geo = F.relu(self.MaskedBatchNorm_2(geo, mask=pvalid))

        # SF-Phase
        lidar_emb = lidar_semantic_embeddings(feats, voxel_logits, vmask)
        fused = self.SemanticFeatureFusionModule_0(
            geo, batch["camera_semantic_embeddings"], lidar_emb)
        return {
            "voxel_logits": voxel_logits,
            "out_logits": self.TorchLinear_3(fused),
            "point_features_pcamera": p_pcam,
            "point_features_camera": p_cam,
            "in_view": in_view,
        }

    def get_loss(self, ret, batch):
        """Voxel CE + Lovász, point CE + Lovász, and the mimic MSE on
        in-view points (camera side detached) -> (loss, dict of terms)."""
        ignored, n_cls = self.ignored_label, self.n_cls
        vl = ret["voxel_logits"].reshape(-1, n_cls)
        vlab = batch["voxel_sem_labels"].reshape(-1)
        vval = batch["voxel_valid"].reshape(-1)
        voxel_ce = L.cross_entropy(vl, vlab, ignored, valid=vval)
        voxel_lvsz = L.lovasz_softmax(torch.softmax(vl, -1), vlab,
                                      ignore=ignored, valid=vval)

        ol = ret["out_logits"].reshape(-1, n_cls)
        plab = batch["point_sem_labels"].reshape(-1)
        pval = batch["point_valid"].reshape(-1)
        out_ce = L.cross_entropy(ol, plab, ignored, valid=pval)
        out_lvsz = L.lovasz_softmax(torch.softmax(ol, -1), plab,
                                    ignore=ignored, valid=pval)

        iv = ret["in_view"][..., None].to(ol.dtype)
        diff = (ret["point_features_pcamera"]
                - ret["point_features_camera"].detach()) * iv
        mimic = dist.global_ratio((diff ** 2).sum(),
                                  iv.sum() * diff.shape[-1])

        loss = voxel_ce + voxel_lvsz + out_ce + out_lvsz + mimic
        return loss, {
            "voxel_ce_loss": voxel_ce, "voxel_lovasz_loss": voxel_lvsz,
            "out_ce_loss": out_ce, "out_lovasz_loss": out_lvsz,
            "out_mimic_loss": mimic,
        }

    @staticmethod
    def predict(ret, batch, test_cfg=None):
        logits = ret["out_logits"]
        return {
            "pred_point_sem_labels": torch.argmax(logits, dim=-1),
            "point_valid": batch["point_valid"],
            "point_softmax": torch.softmax(logits, dim=-1),
        }
