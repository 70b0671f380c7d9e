"""CenterPoint detection head (PyTorch port of
lidarseg3d_tpu/models/bbox_heads/center_head.py): a shared 3x3 conv, one
separable head per task (reg / height / dim / rot [/ vel] / hm, the
heatmap's bias at -2.19), or its DCN variant (a deformable feature
adaption for classification and for regression), the penalty-reduced
focal loss on gaussian heatmaps, the masked L1 regression at the object
centres, and the decoder: top-K, rotated or circle NMS, velocity and the
double-flip merge. Maps are NCHW; the targets come from the host in the
JAX package's NHWC.

Top-K: ``jax.lax.top_k`` returns the lowest flat (NHWC) index first
among equal scores, and at early weights every empty cell scores the
same (sigmoid(-2.19) sits just above the published threshold 0.1), so
the decoder ranks by a stable descending sort of the scores in NHWC
order. ``torch.topk`` promises no order among ties.

In a multi-process run both losses are the global batch's: the focal
loss's sums and positive count, and the regression's sums and mask count,
are summed over the ranks before the division (parallel/dist.py).
"""

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import box_ops
from ...parallel import dist
from ..layers import MaskedBatchNorm, Scopes, add
from ..necks.rpn import Conv
from ..registry import HEADS

DEFAULT_HEADS = {"reg": (2, 2), "height": (1, 2), "dim": (3, 2),
                 "rot": (2, 2)}


class SepHead(nn.Module):
    """heads: name -> (out_channels, num_conv); (num_conv - 1) 3x3 conv +
    BN + ReLU layers of ``head_conv`` channels, then a 3x3 conv."""

    def __init__(self, in_channels, heads, head_conv=64):
        super().__init__()
        s = Scopes()
        self.heads = {}
        for name, (c_out, num_conv) in dict(heads).items():
            layers, c = [], in_channels
            for _ in range(int(num_conv) - 1):
                layers.append((add(self, s, Conv(c, head_conv, 3, 1, 1)),
                               add(self, s, MaskedBatchNorm(
                                   head_conv, channel_dim=1))))
                c = head_conv
            out = add(self, s, Conv(c, int(c_out), 3, 1, 1,
                                    bias_fill=-2.19 if name == "hm"
                                    else 0.0))
            self.heads[name] = (layers, out)

    def forward(self, x):
        out = {}
        for name, (layers, last) in self.heads.items():
            y = x
            for conv, bn in layers:
                y = F.relu(bn(conv(y)))
            out[name] = last(y)
        return out


def deform_conv2d(x, offset, weights, deformable_groups=4):
    """DCN v1 deformable 3x3 conv, stride 1, in plain torch (the JAX
    package's deform_conv2d): per tap learned offsets, bilinear sampling
    with zero padding outside the map, then a sum over the taps.

    x [B, C, H, W]; offset [B, G*K*2, H, W] ((dy, dx) per tap per group,
    channel (g * K + k) * 2 + {0: dy, 1: dx}); weights [K, C, Cout]
    -> [B, Cout, H, W]."""
    B, C, H, W = x.shape
    K = weights.shape[0]
    k = int(round(K ** 0.5))
    G = deformable_groups
    Cg = C // G
    off = offset.permute(0, 2, 3, 1).reshape(B, H, W, G, K, 2)
    base = torch.tensor([(dy - k // 2, dx - k // 2) for dy in range(k)
                         for dx in range(k)], dtype=x.dtype,
                        device=x.device)  # [K, 2]
    yy = torch.arange(H, dtype=x.dtype, device=x.device)[:, None, None,
                                                         None]
    xx = torch.arange(W, dtype=x.dtype, device=x.device)[None, :, None,
                                                         None]
    py = yy + base[:, 0] + off[..., 0]  # [B, H, W, G, K]
    px = xx + base[:, 1] + off[..., 1]
    y0, x0 = torch.floor(py), torch.floor(px)
    wy, wx = (py - y0)[..., None], (px - x0)[..., None]
    xg = x.permute(0, 2, 3, 1).reshape(B, H * W, G, Cg)

    def corner(yi, xi):
        inb = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).to(torch.int64)
        outs = []
        for g in range(G):  # per group: memory H * W * K * Cg
            ig = idx[..., g, :].reshape(B, -1, 1).expand(-1, -1, Cg)
            outs.append(xg[:, :, g].gather(1, ig).reshape(B, H, W, 1, K,
                                                          Cg))
        got = torch.cat(outs, dim=3)  # [B, H, W, G, K, Cg]
        return got * inb[..., None].to(x.dtype)

    sampled = (corner(y0, x0) * (1 - wy) * (1 - wx)
               + corner(y0, x0 + 1) * (1 - wy) * wx
               + corner(y0 + 1, x0) * wy * (1 - wx)
               + corner(y0 + 1, x0 + 1) * wy * wx)  # [B, H, W, G, K, Cg]
    sampled = sampled.transpose(3, 4).reshape(B, H, W, K, C)
    out = torch.einsum("bhwkc,kco->bhwo", sampled, weights)
    return out.permute(0, 3, 1, 2).contiguous()


class FeatureAdaption(nn.Module):
    """A 1x1 offset conv (zero-initialized), the deformable 3x3 conv,
    ReLU."""

    def __init__(self, in_channels, out_channels, kernel_size=3,
                 deformable_groups=4):
        super().__init__()
        K = kernel_size ** 2
        self.deformable_groups = deformable_groups
        self.Conv_0 = Conv(in_channels, deformable_groups * K * 2, 1,
                           weight_fill=0.0, bias_fill=0.0)
        self.deform_kernel = nn.Parameter(torch.empty(K, in_channels,
                                                      out_channels))

    def forward(self, x):
        return F.relu(deform_conv2d(x, self.Conv_0(x), self.deform_kernel,
                                    self.deformable_groups))


class DCNSepHead(nn.Module):
    """Separate DCN-adapted features for the heatmap and the regression
    heads."""

    def __init__(self, in_channels, heads, num_cls, head_conv=64):
        super().__init__()
        c = in_channels
        self.FeatureAdaption_0 = FeatureAdaption(c, c)
        self.FeatureAdaption_1 = FeatureAdaption(c, c)
        self.Conv_0 = Conv(c, head_conv, 3, 1, 1)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(head_conv, channel_dim=1)
        self.Conv_1 = Conv(head_conv, num_cls, 3, 1, 1, bias_fill=-2.19)
        self.SepHead_0 = SepHead(c, {k: v for k, v in dict(heads).items()
                                     if k != "hm"}, head_conv)

    def forward(self, x):
        x_cls = self.FeatureAdaption_0(x)
        x_reg = self.FeatureAdaption_1(x)
        y = F.relu(self.MaskedBatchNorm_0(self.Conv_0(x_cls)))
        out = self.SepHead_0(x_reg)
        out["hm"] = self.Conv_1(y)
        return out


def fast_focal_loss(pred_hm, gt_hm, ind, mask, cat):
    """Penalty-reduced focal loss. pred_hm [B, C, H, W] (sigmoided),
    gt_hm the same; ind [B, M] flat positions y * W + x; mask [B, M];
    cat [B, M] the class of each object."""
    eps = 1e-4
    pred_hm = pred_hm.clamp(eps, 1 - eps)
    neg_weights = torch.pow(1 - gt_hm, 4)
    neg_loss = torch.log(1 - pred_hm) * torch.pow(pred_hm, 2) * neg_weights
    is_pos = (gt_hm >= 1.0 - 1e-6).to(pred_hm.dtype)
    neg_loss = (neg_loss * (1 - is_pos)).sum()
    B, C, H, W = pred_hm.shape
    M = ind.shape[1]
    picked = pred_hm.reshape(B, C, H * W).gather(
        2, ind.to(torch.int64)[:, None, :].expand(B, C, M))  # [B, C, M]
    pos = picked.gather(1, cat.to(torch.int64)[:, None, :])[:, 0]  # [B, M]
    mf = mask.to(pred_hm.dtype)
    pos_loss = (torch.log(pos) * torch.pow(1 - pos, 2) * mf).sum()
    return dist.global_ratio(-(pos_loss + neg_loss), mf.sum())


def reg_loss(pred, target, ind, mask):
    """Masked L1 at the object centres -> [D]; pred [B, D, H, W], target
    [B, M, D]."""
    B, D, H, W = pred.shape
    M = ind.shape[1]
    picked = pred.reshape(B, D, H * W).gather(
        2, ind.to(torch.int64)[:, None, :].expand(B, D, M)).transpose(1, 2)
    mf = mask[..., None].to(pred.dtype)
    num = ((picked - target).abs() * mf).sum(dim=(0, 1))
    den = mf.sum()
    if dist.active():
        tot = dist.all_reduce_sum(torch.cat([num, den.view(1)]))
        num, den = tot[:-1], tot[-1]
    return num / den.clamp(min=1.0)


@HEADS.register_module
class CenterHead(nn.Module):
    def __init__(self, in_channels=512, tasks=(), weight=0.25,
                 code_weights=(1.0,) * 8, common_heads=None,
                 share_conv_channel=64, num_hm_conv=2, dcn_head=False,
                 dataset="waymo", logger=None):
        super().__init__()
        self.tasks = [dict(t) for t in tasks]
        self.weight = weight
        self.code_weights = tuple(code_weights)
        self.Conv_0 = Conv(in_channels, share_conv_channel, 3, 1, 1,
                           bias=False)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(share_conv_channel,
                                                 channel_dim=1)
        heads = dict(common_heads or DEFAULT_HEADS)
        self.task_heads = []
        for i, task in enumerate(self.tasks):
            ncls = int(task["num_class"])
            if dcn_head:
                m = DCNSepHead(share_conv_channel, heads, ncls)
                setattr(self, f"DCNSepHead_{i}", m)
            else:
                m = SepHead(share_conv_channel,
                            dict(heads, hm=(ncls, num_hm_conv)))
                setattr(self, f"SepHead_{i}", m)
            self.task_heads.append(m)

    def forward(self, x):
        """x: [B, C, H, W] BEV features -> list of per-task map dicts."""
        y = F.relu(self.MaskedBatchNorm_0(self.Conv_0(x)))
        return [h(y) for h in self.task_heads]

    def get_loss(self, rets, targets):
        """targets: per-task dicts of hm [B, H, W, C], ind / mask / cat
        [B, M], anno_box [B, M, D] (core/center_targets.py). The box
        prediction concatenates reg / height / dim [/ vel] / rot; a 10-dim
        target against a head without vel drops its columns 6:8."""
        total = 0.0
        ldict = {}
        for ti, (ret, tgt) in enumerate(zip(rets, targets)):
            hm_loss = fast_focal_loss(
                torch.sigmoid(ret["hm"]), tgt["hm"].permute(0, 3, 1, 2),
                tgt["ind"], tgt["mask"], tgt["cat"])
            parts = [ret["reg"], ret["height"], ret["dim"]]
            if "vel" in ret:
                parts.append(ret["vel"])
            parts.append(ret["rot"])
            target = tgt["anno_box"]
            if "vel" not in ret and target.shape[-1] == 10:
                target = target[..., [0, 1, 2, 3, 4, 5, 8, 9]]
            if "vel" in ret and target.shape[-1] != 10:
                raise ValueError(
                    "a head with a vel output trains on boxes with velocity "
                    f"(10-dim targets), got {target.shape[-1]}-dim: the "
                    "Waymo converter's boxes carry none (ROADMAP §C)")
            loc = reg_loss(torch.cat(parts, dim=1), target, tgt["ind"],
                           tgt["mask"])
            cw = torch.tensor(self.code_weights[:loc.shape[0]],
                              dtype=loc.dtype, device=loc.device)
            loc_loss = (loc * cw).sum()
            total = total + hm_loss + self.weight * loc_loss
            ldict[f"task{ti}_hm_loss"] = hm_loss
            ldict[f"task{ti}_loc_loss"] = loc_loss
        return total, ldict

    @staticmethod
    def _double_flip_maps(ret):
        """Merge groups of 4 double-flip rows (original, y = -y, x = -x,
        both; DoubleFlip) into one prediction: each variant's NHWC map
        un-flipped, the sign and sub-cell offset channels fixed, averaged
        (hm after the sigmoid, dim after exp, rot as its sin and cos
        components) -> (hm, height, dim, reg, rots, rotc, vel) at B / 4."""
        def grp(t):
            B = t.shape[0]
            assert B % 4 == 0, f"double_flip batch must be 4*frames, got {B}"
            return t.reshape(B // 4, 4, *t.shape[1:])

        def unflip(t):
            return (t[:, 0], t[:, 1].flip(1), t[:, 2].flip(2),
                    t[:, 3].flip(1, 2))

        def mean4(t):
            return torch.stack(unflip(grp(t)), 1).mean(1)

        hm = mean4(torch.sigmoid(ret["hm"]))
        height = mean4(ret["height"])
        dim = mean4(torch.exp(ret["dim"]))
        r0, r1, r2, r3 = unflip(grp(ret["reg"]))
        r1 = torch.cat([r1[..., :1], 1.0 - r1[..., 1:2]], -1)
        r2 = torch.cat([1.0 - r2[..., :1], r2[..., 1:2]], -1)
        r3 = 1.0 - r3
        reg = (r0 + r1 + r2 + r3) / 4.0
        s0, s1, s2, s3 = unflip(grp(ret["rot"][..., 0:1]))
        c0, c1, c2, c3 = unflip(grp(ret["rot"][..., 1:2]))
        rots = (s0 + s1 - s2 - s3) / 4.0
        rotc = (c0 - c1 + c2 - c3) / 4.0
        vel = None
        if "vel" in ret:
            v0, v1, v2, v3 = unflip(grp(ret["vel"]))
            flip_x = torch.tensor([-1.0, 1.0], dtype=v0.dtype,
                                  device=v0.device)
            flip_y = torch.tensor([1.0, -1.0], dtype=v0.dtype,
                                  device=v0.device)
            vel = (v0 + v1 * flip_y + v2 * flip_x - v3) / 4.0
        return hm, height, dim, reg, rots, rotc, vel

    @staticmethod
    def decode(rets, voxel_size, pc_range, out_factor=8, k=100,
               score_threshold=0.1, nms_iou=0.5, max_out=83,
               nms_type="rotated", min_radius=None, double_flip=False):
        """Per-task top-K decode + BEV NMS ("rotated": the BEV IoU; "circle":
        the squared centre distance against the task's ``min_radius``);
        ``double_flip``: the batch holds groups of 4 flip variants, merged
        first. -> list of dicts (box3d [B, max_out, 7], scores, labels,
        valid [, velocity [B, max_out, 2]])."""
        outs = []
        for ti, ret in enumerate(rets):
            ret = {n: t.permute(0, 2, 3, 1) for n, t in ret.items()}
            if double_flip:
                (hm, height_m, dim_m, reg_m, rots_m, rotc_m,
                 vel_m) = CenterHead._double_flip_maps(ret)
            else:
                hm = torch.sigmoid(ret["hm"])
                height_m, reg_m = ret["height"], ret["reg"]
                dim_m = torch.exp(ret["dim"])
                rots_m = ret["rot"][..., 0:1]
                rotc_m = ret["rot"][..., 1:2]
                vel_m = ret.get("vel")
            B, H, W, C = hm.shape
            flat = hm.reshape(B, H * W * C)
            # the lowest flat index first among ties, as jax.lax.top_k
            order = torch.sort(flat, dim=1, descending=True, stable=True)
            scores, idx = order.values[:, :k], order.indices[:, :k]
            cls = idx % C
            pos = idx // C
            ys = (pos // W).to(torch.float32)
            xs = (pos % W).to(torch.float32)

            def pick(t):
                f = t.reshape(B, H * W, t.shape[-1])
                return f.gather(1, pos[..., None].expand(B, k, t.shape[-1]))

            reg = pick(reg_m)
            height = pick(height_m)[..., 0]
            dim = pick(dim_m)
            yaw = torch.atan2(pick(rots_m)[..., 0], pick(rotc_m)[..., 0])
            x = (xs + reg[..., 0]) * out_factor * voxel_size[0] + pc_range[0]
            y = (ys + reg[..., 1]) * out_factor * voxel_size[1] + pc_range[1]
            boxes7 = torch.stack([x, y, height, dim[..., 0], dim[..., 1],
                                  dim[..., 2], yaw], dim=-1)
            if nms_type == "circle":
                radius = (min_radius[ti] if isinstance(min_radius,
                                                       (list, tuple))
                          else min_radius)
                sel, valid = box_ops.circle_nms(boxes7[..., :2], scores,
                                                radius, max_out)
            else:
                bev = boxes7[..., [0, 1, 3, 4, 6]]
                sel, valid = box_ops.nms_bev(bev, scores, nms_iou, max_out)
            sel = sel.clamp(0, k - 1).to(torch.int64)
            s = scores.gather(1, sel)
            out = {"box3d": boxes7.gather(1, sel[..., None].expand(
                       B, sel.shape[1], 7)),
                   "scores": s, "labels": cls.gather(1, sel),
                   "valid": valid & (s > score_threshold)}
            if vel_m is not None:
                vel = pick(vel_m)
                out["velocity"] = vel.gather(1, sel[..., None].expand(
                    B, sel.shape[1], 2))
            outs.append(out)
        return outs
