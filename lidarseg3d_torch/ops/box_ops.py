"""Rotated-box geometry of the detection stack (PyTorch port of
lidarseg3d_tpu/ops/box_ops.py): BEV corners, the rotated BEV and 3D IoU
by polygon clipping, rotated NMS and CenterPoint's circle NMS.

Plain torch on the tensors' device: no kernel of the port stands behind
these ops (the JAX package's are XLA, not Pallas). The Sutherland-Hodgman
clip of the JAX package (a ``fori_loop`` over a fixed 8-vertex polygon,
``vmap``ped over the pairs) runs here on every pair at once: the 4 half
planes and 8 vertex steps are Python loops over [P, 8, 2] tensors. The
NMS keeps the JAX package's masked iterative argmax over a batch of rows
(``min(max_out, n)`` rounds, the first maximum on ties).
"""

import torch

MAXV = 8  # vertex capacity of a clipped polygon (4 half planes on a quad)


def box_to_corners_2d(boxes):
    """[..., 5] (cx, cy, dx, dy, yaw) -> [..., 4, 2] corners (ccw)."""
    cx, cy, dx, dy, yaw = boxes.unbind(-1)
    c, s = torch.cos(yaw), torch.sin(yaw)
    hx, hy = dx / 2, dy / 2
    local = torch.stack([
        torch.stack([hx, hy], -1), torch.stack([-hx, hy], -1),
        torch.stack([-hx, -hy], -1), torch.stack([hx, -hy], -1),
    ], dim=-2)  # [..., 4, 2]
    rot = torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)],
                      dim=-2)  # [..., 2, 2]
    pts = torch.einsum("...ij,...kj->...ki", rot, local)
    return pts + torch.stack([cx, cy], -1)[..., None, :]


def _edges_to_half_planes(corners):
    """[..., 4, 2] ccw corners -> [..., 4, 3] inward half planes
    (a, b, c) with a x + b y + c >= 0 inside."""
    d = torch.roll(corners, -1, dims=-2) - corners
    a, b = -d[..., 1], d[..., 0]
    c = -(a * corners[..., 0] + b * corners[..., 1])
    return torch.stack([a, b, c], dim=-1)


def _clip_polygons(subject, planes):
    """Sutherland-Hodgman clip of P polygons by their 4 half planes.
    subject [P, MAXV, 2] (the first ``4`` vertices valid), planes
    [P, 4, 3] -> (polygon [P, MAXV, 2], vertex count [P])."""
    P = subject.shape[0]
    slots = torch.arange(MAXV, device=subject.device)
    poly = subject
    cnt = torch.full((P,), 4, dtype=torch.int64, device=subject.device)
    for h in range(4):
        a, b, c = (planes[:, h, j, None] for j in range(3))  # [P, 1]
        out = torch.zeros_like(poly)
        m = torch.zeros_like(cnt)
        for i in range(MAXV):
            cur = poly[:, i % MAXV]
            nidx = (i + 1) % cnt.clamp(min=1)
            nxt = poly.gather(1, nidx[:, None, None].expand(P, 1, 2))[:, 0]
            cur_in = (a * cur[:, :1] + b * cur[:, 1:] + c >= 0)[:, 0]
            nxt_in = (a * nxt[:, :1] + b * nxt[:, 1:] + c >= 0)[:, 0]
            valid = i < cnt
            denom = a * (nxt[:, :1] - cur[:, :1]) + b * (nxt[:, 1:]
                                                         - cur[:, 1:])
            denom = torch.where(denom.abs() < 1e-12,
                                torch.full_like(denom, 1e-12), denom)
            t = -(a * cur[:, :1] + b * cur[:, 1:] + c) / denom
            inter = cur + t.clamp(0.0, 1.0) * (nxt - cur)
            for emit, pt in ((valid & cur_in, cur),
                             (valid & (cur_in ^ nxt_in), inter)):
                at = (slots[None, :] == (m % MAXV)[:, None]) & emit[:, None]
                out = torch.where(at[..., None], pt[:, None, :], out)
                m = m + emit.to(m.dtype)
        poly, cnt = out, m.clamp(max=MAXV)
    return poly, cnt


def _poly_area(poly, cnt):
    """Shoelace area of [P, MAXV, 2] polygons of ``cnt`` vertices."""
    idx = torch.arange(MAXV, device=poly.device)
    nxt = (idx[None, :] + 1) % cnt.clamp(min=1)[:, None]
    valid = idx[None, :] < cnt[:, None]
    x, y = poly[..., 0], poly[..., 1]
    cross = x * y.gather(1, nxt) - x.gather(1, nxt) * y
    return torch.where(valid, cross, torch.zeros_like(cross)).sum(1).abs() / 2


def _pair_intersection(ca, cb):
    """BEV intersection areas [Na, Nb] of the ccw corner sets ca [Na, 4, 2]
    and cb [Nb, 4, 2]."""
    na, nb = ca.shape[0], cb.shape[0]
    subject = torch.cat([ca, ca[:, -1:].expand(na, MAXV - 4, 2)], dim=1)
    subject = subject[:, None].expand(na, nb, MAXV, 2).reshape(-1, MAXV, 2)
    planes = _edges_to_half_planes(cb)[None].expand(na, nb, 4, 3)
    poly, cnt = _clip_polygons(subject, planes.reshape(-1, 4, 3))
    return _poly_area(poly, cnt).reshape(na, nb)


def boxes_iou_bev(boxes_a, boxes_b):
    """Rotated BEV IoU matrix [Na, Nb] for [N, 5] (cx, cy, dx, dy, yaw)."""
    inter = _pair_intersection(box_to_corners_2d(boxes_a),
                               box_to_corners_2d(boxes_b))
    area_a = boxes_a[:, 2] * boxes_a[:, 3]
    area_b = boxes_b[:, 2] * boxes_b[:, 3]
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / union.clamp(min=1e-9)


def _greedy_select(scores, suppress, max_out):
    """The masked iterative argmax over rows: scores [B, n], suppress
    [B, n, n] bool (row j's mask of the boxes it suppresses) -> (picked
    [B, max_out] int32, -1 where empty; valid [B, max_out])."""
    B, n = scores.shape
    dev = scores.device
    alive = torch.ones((B, n), dtype=torch.bool, device=dev)
    picked = torch.full((B, max_out), -1, dtype=torch.int32, device=dev)
    pmask = torch.zeros((B, max_out), dtype=torch.bool, device=dev)
    ar = torch.arange(n, device=dev)
    neg = torch.full_like(scores, -torch.inf)
    for i in range(min(max_out, n)):
        masked = torch.where(alive, scores, neg)
        j = masked.argmax(dim=1)  # the first maximum on ties
        ok = masked.gather(1, j[:, None])[:, 0] > -torch.inf
        picked[:, i] = torch.where(ok, j, -1).to(torch.int32)
        pmask[:, i] = ok
        sup = suppress.gather(1, j[:, None, None].expand(B, 1, n))[:, 0]
        alive = alive & ~sup & (ar[None, :] != j[:, None]) & ok[:, None]
    return picked, pmask


def nms_bev(boxes, scores, iou_threshold=0.5, max_out=128):
    """Rotated NMS of one row ([n, 5], [n]) or a batch of rows ([B, n, 5],
    [B, n]) -> (indices [.., max_out] int32, -1 past the last pick; valid
    [.., max_out])."""
    one = scores.dim() == 1
    if one:
        boxes, scores = boxes[None], scores[None]
    iou = torch.stack([boxes_iou_bev(b, b) for b in boxes])
    picked, valid = _greedy_select(scores, iou > iou_threshold, max_out)
    return (picked[0], valid[0]) if one else (picked, valid)


def circle_nms(centers, scores, min_radius, max_out=83):
    """CenterPoint circle NMS of one row ([n, 2], [n]) or a batch: a box
    suppresses those whose SQUARED centre distance is <= ``min_radius``
    (the reference compares the squared distance with the raw threshold;
    the JAX package keeps that, and so does the port) -> (indices, valid)
    as ``nms_bev``."""
    one = scores.dim() == 1
    if one:
        centers, scores = centers[None], scores[None]
    d2 = ((centers[:, :, None, :] - centers[:, None, :, :]) ** 2).sum(-1)
    picked, valid = _greedy_select(scores, d2 <= min_radius, max_out)
    return (picked[0], valid[0]) if one else (picked, valid)


def boxes_iou_3d(boxes_a, boxes_b):
    """3D IoU matrix [Na, Nb] for [N, 7] (x, y, z, dx, dy, dz, yaw): the
    rotated BEV intersection times the z overlap (z the box centre) over
    the union of the volumes."""
    sel = [0, 1, 3, 4, 6]
    inter_bev = _pair_intersection(box_to_corners_2d(boxes_a[:, sel]),
                                   box_to_corners_2d(boxes_b[:, sel]))
    za0 = boxes_a[:, 2] - boxes_a[:, 5] / 2
    za1 = boxes_a[:, 2] + boxes_a[:, 5] / 2
    zb0 = boxes_b[:, 2] - boxes_b[:, 5] / 2
    zb1 = boxes_b[:, 2] + boxes_b[:, 5] / 2
    zo = (torch.minimum(za1[:, None], zb1[None, :])
          - torch.maximum(za0[:, None], zb0[None, :])).clamp(min=0.0)
    inter = inter_bev * zo
    vol_a = boxes_a[:, 3] * boxes_a[:, 4] * boxes_a[:, 5]
    vol_b = boxes_b[:, 3] * boxes_b[:, 4] * boxes_b[:, 5]
    union = vol_a[:, None] + vol_b[None, :] - inter
    return inter / union.clamp(min=1e-9)


def rotate_points_along_z(points, angle):
    """points [..., >=3], angle [...]: rotate the xy plane by +angle about
    z."""
    c, s = torch.cos(angle), torch.sin(angle)
    x = points[..., 0] * c - points[..., 1] * s
    y = points[..., 0] * s + points[..., 1] * c
    return torch.cat([torch.stack([x, y], -1), points[..., 2:]], dim=-1)
