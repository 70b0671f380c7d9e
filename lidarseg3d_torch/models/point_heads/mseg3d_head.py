"""MSeg3D multimodal fusion point head (PyTorch port of
lidarseg3d_tpu/models/point_heads/mseg3d_head.py:123 PointSegMSeg3DHead,
evaluation path: dropout is the identity, BN uses running statistics).

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

from ...ops import grid_sample as gs
from ...ops import interpolate as interp
from ..layers import MaskedBatchNorm, MLPHead, TorchLinear
from ..registry import POINT_HEADS


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
    def __init__(self, d_input_point, d_camera_emb, d_lidar_emb, d_model=96,
                 n_head=4, n_layer=6, n_ffn=192):
        super().__init__()
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
            tgt, memory = layer(tgt, memory)
        return self.LayerNorm_0(tgt)


@POINT_HEADS.register_module
class PointSegMSeg3DHead(nn.Module):
    def __init__(self, class_agnostic=False, num_class=20, model_cfg=None,
                 voxel_size=(), point_cloud_range=()):
        super().__init__()
        cfg = dict(model_cfg or {})
        if cfg.get("OOV_COMPLETION", "pseudo_camera") != "pseudo_camera":
            raise NotImplementedError("OOV_COMPLETION other than "
                                      "pseudo_camera")
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        n_cls = 1 if class_agnostic else num_class
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
            n_layer=sf["n_layer"], n_ffn=sf["n_ffn"])
        self.TorchLinear_3 = TorchLinear(sf["d_model"], num_class)

    def forward(self, batch):
        feats = batch["conv_point_features"]  # [B, V, C_vox]
        struct = batch["conv_structure"]
        vmask = struct.valid_mask()
        pvalid = batch["point_valid"]

        voxel_logits = self.MLPHead_0(feats, mask=vmask)

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

    @staticmethod
    def predict(ret, batch, test_cfg=None):
        logits = ret["out_logits"]
        return {
            "pred_point_sem_labels": torch.argmax(logits, dim=-1),
            "point_valid": batch["point_valid"],
            "point_softmax": torch.softmax(logits, dim=-1),
        }
