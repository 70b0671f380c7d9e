"""Devkit-free detection metrics (own copy of
lidarseg3d_tpu/core/det_metrics.py): Waymo-style AP / APH at a BEV-IoU
match (101-point interpolated; APH weights each true positive by its
heading accuracy 1 - |wrap(dtheta)| / pi) and the nuScenes mAP term (AP
averaged over the centre-distance gates 0.5 / 1 / 2 / 4 m), with greedy
score-ordered 1:1 matching over per-frame dicts in the box layout
[x, y, z, dx, dy, dz, yaw, ...].
"""

import numpy as np


def _wrap_angle(a):
    return (a + np.pi) % (2 * np.pi) - np.pi


def _bev_iou(boxes_a, boxes_b):
    """Rotated BEV IoU matrix of [N, >=7] boxes (ops/box_ops.py on the
    CPU, float32)."""
    if len(boxes_a) == 0 or len(boxes_b) == 0:
        return np.zeros((len(boxes_a), len(boxes_b)), np.float32)
    import torch

    from ..ops import box_ops

    def bev(b):
        return torch.from_numpy(np.ascontiguousarray(np.stack(
            [b[:, 0], b[:, 1], b[:, 3], b[:, 4], b[:, 6]], -1),
            dtype=np.float32))

    return box_ops.boxes_iou_bev(bev(boxes_a), bev(boxes_b)).numpy()


def _match_frames(frames, affinity_fn, threshold, larger_is_better=True):
    """Greedy score-ordered 1:1 matching across frames.

    frames: list of (det_boxes [N, >=7], det_scores [N], gt_boxes [M, >=7]).
    Returns (scores, is_tp, heading_acc, n_gt): flat arrays over all
    frames' detections, sorted by score descending.
    """
    all_scores, all_tp, all_ha = [], [], []
    n_gt = 0
    for det_boxes, det_scores, gt_boxes in frames:
        n_gt += len(gt_boxes)
        order = np.argsort(-det_scores)
        aff = affinity_fn(det_boxes, gt_boxes)
        taken = np.zeros(len(gt_boxes), bool)
        for i in order:
            all_scores.append(det_scores[i])
            best, best_j = None, -1
            for j in range(len(gt_boxes)):
                if taken[j]:
                    continue
                a = aff[i, j]
                ok = a >= threshold if larger_is_better else a <= threshold
                if ok and (best is None
                           or (a > best if larger_is_better else a < best)):
                    best, best_j = a, j
            if best_j >= 0:
                taken[best_j] = True
                all_tp.append(True)
                dth = abs(_wrap_angle(det_boxes[i, 6] - gt_boxes[best_j, 6]))
                all_ha.append(1.0 - dth / np.pi)
            else:
                all_tp.append(False)
                all_ha.append(0.0)
    scores = np.asarray(all_scores, np.float64)
    order = np.argsort(-scores)
    return (scores[order], np.asarray(all_tp, bool)[order],
            np.asarray(all_ha, np.float64)[order], n_gt)


def _ap_from_matches(is_tp, weights, n_gt, n_points=101):
    """Interpolated AP: precision envelope sampled at n_points recalls."""
    if n_gt == 0:
        return float("nan")
    if len(is_tp) == 0:
        return 0.0
    tp = np.cumsum(np.where(is_tp, weights, 0.0))
    fp = np.cumsum(~is_tp)
    recall = tp / n_gt
    precision = tp / np.maximum(tp + fp, 1e-9)
    # monotone precision envelope
    precision = np.maximum.accumulate(precision[::-1])[::-1]
    out = 0.0
    for r in np.linspace(0, 1, n_points):
        p = precision[recall >= r]
        out += (p[0] if len(p) else 0.0)
    return out / n_points


def waymo_ap(frames_by_class, iou_thresholds=None):
    """frames_by_class: {class_name: [(det_boxes, det_scores, gt_boxes)]}.

    Returns {class: {"AP": x, "APH": y}} plus "mAP"/"mAPH" means.
    Default thresholds: VEHICLE 0.7, PEDESTRIAN/CYCLIST 0.5 (the official
    L1/L2 difficulty split needs per-box point counts and is out of scope
    — this is the single-difficulty BEV-IoU AP)."""
    iou_thresholds = dict(iou_thresholds or {
        "VEHICLE": 0.7, "PEDESTRIAN": 0.5, "CYCLIST": 0.5})
    out = {}
    aps, aphs = [], []
    for cls, frames in frames_by_class.items():
        thr = iou_thresholds.get(cls, 0.5)
        scores, is_tp, ha, n_gt = _match_frames(
            frames, _bev_iou, thr, larger_is_better=True)
        ap = _ap_from_matches(is_tp, np.ones_like(ha), n_gt)
        aph = _ap_from_matches(is_tp, ha, n_gt)
        out[cls] = {"AP": ap, "APH": aph}
        if not np.isnan(ap):
            aps.append(ap)
            aphs.append(aph)
    out["mAP"] = float(np.mean(aps)) if aps else float("nan")
    out["mAPH"] = float(np.mean(aphs)) if aphs else float("nan")
    return out


def _center_dist(det_boxes, gt_boxes):
    if len(det_boxes) == 0 or len(gt_boxes) == 0:
        return np.zeros((len(det_boxes), len(gt_boxes)), np.float32)
    return np.linalg.norm(
        det_boxes[:, None, :2] - gt_boxes[None, :, :2], axis=-1)


def nusc_map(frames_by_class, dist_thresholds=(0.5, 1.0, 2.0, 4.0)):
    """nuScenes mAP term: per-class AP averaged over the BEV
    center-distance gates (eval.detection semantics, without the min
    recall/precision clamps of the full NDS)."""
    out = {}
    aps_all = []
    for cls, frames in frames_by_class.items():
        aps = []
        for thr in dist_thresholds:
            scores, is_tp, _, n_gt = _match_frames(
                frames, _center_dist, thr, larger_is_better=False)
            aps.append(_ap_from_matches(is_tp, np.ones(len(is_tp)), n_gt))
        ap = float(np.nanmean(aps))
        out[cls] = {"AP": ap}
        if not np.isnan(ap):
            aps_all.append(ap)
    out["mAP"] = float(np.mean(aps_all)) if aps_all else float("nan")
    return out


def group_detections_by_class(detections, gts, class_names):
    """Convenience: {token: det-dict} + {token: (gt_boxes, gt_names)} ->
    frames_by_class for the scorers. det-dicts are run_det_eval outputs
    ({box3d_lidar, scores, label_preds, valid})."""
    frames = {c: [] for c in class_names}
    for token, det in detections.items():
        gt_boxes, gt_names = gts[token]
        gt_boxes = np.asarray(gt_boxes, np.float64)
        valid = np.asarray(det.get("valid", np.ones(
            len(det["box3d_lidar"]), bool)), bool)
        boxes = np.asarray(det["box3d_lidar"], np.float64)[valid]
        scores = np.asarray(det["scores"], np.float64)[valid]
        labels = np.asarray(det["label_preds"], np.int64)[valid]
        for ci, cls in enumerate(class_names):
            sel = labels == ci
            gsel = np.asarray([n == cls for n in gt_names], bool)
            frames[cls].append(
                (boxes[sel], scores[sel],
                 gt_boxes[gsel] if len(gt_boxes) else gt_boxes.reshape(0, 7)))
    return frames
