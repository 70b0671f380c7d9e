"""Host-side CenterPoint target assignment (own copy of
lidarseg3d_tpu/core/center_targets.py): per task, a gaussian per gt box
on its class heatmap, and each box's centre index and regression target.
"""

import numpy as np


def gaussian_radius(height, width, min_overlap=0.5):
    a1 = 1
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    sq1 = np.sqrt(max(b1 ** 2 - 4 * a1 * c1, 0))
    r1 = (b1 + sq1) / 2
    a2 = 4
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    sq2 = np.sqrt(max(b2 ** 2 - 4 * a2 * c2, 0))
    r2 = (b2 + sq2) / 2
    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    sq3 = np.sqrt(max(b3 ** 2 - 4 * a3 * c3, 0))
    r3 = (b3 + sq3) / 2
    return min(r1, r2, r3)


def draw_gaussian(heatmap, center, radius):
    radius = max(int(radius), 1)
    diameter = 2 * radius + 1
    sigma = diameter / 6
    xs = np.arange(-radius, radius + 1)
    g = np.exp(-(xs[None, :] ** 2 + xs[:, None] ** 2) / (2 * sigma ** 2))
    x, y = int(center[0]), int(center[1])
    H, W = heatmap.shape
    left, right = min(x, radius), min(W - x, radius + 1)
    top, bottom = min(y, radius), min(H - y, radius + 1)
    if left + right <= 0 or top + bottom <= 0:
        return
    masked = heatmap[y - top:y + bottom, x - left:x + right]
    masked_g = g[radius - top:radius + bottom, radius - left:radius + right]
    np.maximum(masked, masked_g, out=masked)


def assign_center_targets(gt_boxes, gt_classes, task_class_ids, grid_hw,
                          voxel_size, pc_range, out_factor=8, max_objs=100,
                          min_overlap=0.5):
    """gt_boxes: [N, 7] (x, y, z, dx, dy, dz, yaw) or [N, 9] with BEV
    velocity appended (x, y, z, dx, dy, dz, yaw, vx, vy — note: this repo
    keeps yaw at column 6 everywhere; the reference's nuScenes layout puts
    vel at 6:8 and yaw last, preprocess.py:401-405); gt_classes: [N] global
    class ids; task_class_ids: list per task of the class ids it owns.

    Returns per-task dicts: hm [H, W, C_t], ind/mask/cat [max_objs],
    anno_box [max_objs, 8] = (dx, dy, z, log dims, sin yaw, cos yaw) or,
    for 9-dim boxes, [max_objs, 10] with (vx, vy) before the rotation —
    the reference's velocity target order (preds concat reg/height/dim/
    vel/rot, center_head.py:261-263)."""
    H, W = grid_hw
    gt_boxes = np.asarray(gt_boxes, np.float32).reshape(len(gt_boxes), -1) \
        if len(gt_boxes) else np.zeros((0, 7), np.float32)
    with_vel = gt_boxes.shape[-1] >= 9
    D = 10 if with_vel else 8
    out = []
    for cls_ids in task_class_ids:
        C = len(cls_ids)
        hm = np.zeros((H, W, C), np.float32)
        ind = np.zeros((max_objs,), np.int64)
        mask = np.zeros((max_objs,), bool)
        cat = np.zeros((max_objs,), np.int64)
        anno = np.zeros((max_objs, D), np.float32)
        m = 0
        for box, gcls in zip(gt_boxes, gt_classes):
            if gcls not in cls_ids or m >= max_objs:
                continue
            tcls = cls_ids.index(gcls)
            x, y, z, dx, dy, dz, yaw = box[:7]
            w_pix = dx / voxel_size[0] / out_factor
            h_pix = dy / voxel_size[1] / out_factor
            if w_pix <= 0 or h_pix <= 0:
                continue
            cx = (x - pc_range[0]) / voxel_size[0] / out_factor
            cy = (y - pc_range[1]) / voxel_size[1] / out_factor
            ci, cj = int(cx), int(cy)
            if not (0 <= ci < W and 0 <= cj < H):
                continue
            r = gaussian_radius(h_pix, w_pix, min_overlap)
            draw_gaussian(hm[:, :, tcls], (ci, cj), r)
            hm[cj, ci, tcls] = 1.0  # exact positive at the center
            ind[m] = cj * W + ci
            mask[m] = True
            cat[m] = tcls
            row = [cx - ci, cy - cj, z, np.log(dx), np.log(dy), np.log(dz)]
            if with_vel:
                row += [box[7], box[8]]
            row += [np.sin(yaw), np.cos(yaw)]
            anno[m] = row
            m += 1
        out.append({"hm": hm, "ind": ind, "mask": mask, "cat": cat,
                    "anno_box": anno})
    return out
