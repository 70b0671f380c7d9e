"""Host-side (numpy) 3D box utilities of the detection pipeline (own copy
of lidarseg3d_tpu/core/box_np_ops.py): BEV corners, points in rotated
boxes (gt database extraction, min_points filtering), rotated-BEV box
collision (gt-sampling placement) and the global augmentations applied to
points and boxes together. Box layout: [x, y, z, dx, dy, dz, yaw] with z
the box centre, BEV velocity at columns 7:9 where present. Every draw
comes from the frame's generator, in the JAX package's order.
"""

import numpy as np


def bev_corners(boxes):
    """[N, 7] -> [N, 4, 2] rotated BEV corners (ccw)."""
    x, y = boxes[:, 0], boxes[:, 1]
    dx, dy = boxes[:, 3], boxes[:, 4]
    yaw = boxes[:, 6]
    c, s = np.cos(yaw), np.sin(yaw)
    hx, hy = dx / 2, dy / 2
    local = np.stack([
        np.stack([hx, hy], -1), np.stack([-hx, hy], -1),
        np.stack([-hx, -hy], -1), np.stack([hx, -hy], -1),
    ], axis=1)  # [N, 4, 2]
    rot = np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], axis=1)
    pts = np.einsum("nij,nkj->nki", rot, local)
    return pts + np.stack([x, y], -1)[:, None, :]


def points_in_rbbox(points, boxes, margin=0.0):
    """[P, >=3] points x [N, 7] boxes -> [P, N] bool membership."""
    if len(boxes) == 0 or len(points) == 0:
        return np.zeros((len(points), len(boxes)), bool)
    d = points[:, None, :2] - boxes[None, :, :2]  # [P, N, 2]
    c, s = np.cos(boxes[:, 6]), np.sin(boxes[:, 6])
    # rotate into the box frame (by -yaw)
    lx = d[..., 0] * c[None, :] + d[..., 1] * s[None, :]
    ly = -d[..., 0] * s[None, :] + d[..., 1] * c[None, :]
    in_xy = (
        (np.abs(lx) <= boxes[None, :, 3] / 2 + margin)
        & (np.abs(ly) <= boxes[None, :, 4] / 2 + margin)
    )
    dz = points[:, None, 2] - boxes[None, :, 2]
    in_z = np.abs(dz) <= boxes[None, :, 5] / 2 + margin
    return in_xy & in_z


def _project(corners, axis):
    """corners [N, 4, 2], axis [2] -> (min, max) per box."""
    p = corners @ axis
    return p.min(axis=1), p.max(axis=1)


def boxes_bev_collide(boxes_a, boxes_b):
    """[Na, 7] x [Nb, 7] -> [Na, Nb] bool rotated-BEV overlap.

    Exact separating-axis test on the 4 edge normals of each pair."""
    na, nb = len(boxes_a), len(boxes_b)
    if na == 0 or nb == 0:
        return np.zeros((na, nb), bool)
    ca, cb = bev_corners(boxes_a), bev_corners(boxes_b)
    collide = np.ones((na, nb), bool)
    for corners, src in ((ca, 0), (cb, 1)):
        edges = np.roll(corners, -1, axis=1) - corners  # [N, 4, 2]
        normals = np.stack([-edges[..., 1], edges[..., 0]], -1)  # [N, 4, 2]
        for k in range(4):
            ax = normals[:, k, :]  # per-box axis
            if src == 0:
                pa = np.einsum("nij,nj->ni", ca, ax)  # [Na, 4]
                pb = np.einsum("mij,nj->nmi", cb, ax)  # [Na, Nb, 4]
                sep = (pb.max(-1) < pa.min(-1)[:, None]) | (
                    pb.min(-1) > pa.max(-1)[:, None])
            else:
                pb = np.einsum("mij,mj->mi", cb, ax)  # [Nb, 4]
                pa = np.einsum("nij,mj->nmi", ca, ax)  # [Na, Nb, 4]
                sep = (pa.max(-1) < pb.min(-1)[None, :]) | (
                    pa.min(-1) > pb.max(-1)[None, :])
            collide &= ~sep
    return collide


def random_flip_both(boxes, points, rng):
    """CenterPoint's random_flip_both: independent x-axis and y-axis flips
    with p=0.5 each (core/sampler/preprocess.py:803-832). Boxes may carry
    BEV velocity at columns 7:9 ([x,y,z,dx,dy,dz,yaw,vx,vy] — this repo
    keeps yaw at 6); flips negate the matching velocity component."""
    with_vel = len(boxes) and boxes.shape[-1] >= 9
    if rng.random() < 0.5:  # flip over x axis: y -> -y
        points = points.copy()
        points[:, 1] = -points[:, 1]
        if len(boxes):
            boxes = boxes.copy()
            boxes[:, 1] = -boxes[:, 1]
            boxes[:, 6] = -boxes[:, 6]
            if with_vel:
                boxes[:, 8] = -boxes[:, 8]
    if rng.random() < 0.5:  # flip over y axis: x -> -x
        points = points.copy()
        points[:, 0] = -points[:, 0]
        if len(boxes):
            boxes = boxes.copy()
            boxes[:, 0] = -boxes[:, 0]
            boxes[:, 6] = np.pi - boxes[:, 6]
            if with_vel:
                boxes[:, 7] = -boxes[:, 7]
    return boxes, points


def global_rotation(boxes, points, rotation, rng):
    """Global z rotation. Velocity (cols 7:9 when present) rotates with the
    scene — NOTE: the reference's global_rotation_v2 (preprocess.py:842-851)
    leaves velocity unrotated, a fidelity gap vs the original CenterPoint;
    we keep the physically consistent transform."""
    angle = rng.uniform(rotation[0], rotation[1])
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[c, -s], [s, c]], points.dtype)
    points = points.copy()
    points[:, :2] = points[:, :2] @ rot.T
    if len(boxes):
        boxes = boxes.copy()
        boxes[:, :2] = boxes[:, :2] @ rot.T
        boxes[:, 6] += angle
        if boxes.shape[-1] >= 9:
            boxes[:, 7:9] = boxes[:, 7:9] @ rot.T
    return boxes, points


def global_scaling(boxes, points, min_scale, max_scale, rng):
    """Scales positions, dims, and velocity (reference global_scaling_v2
    scales every column but the rotation, preprocess.py:835-839)."""
    s = rng.uniform(min_scale, max_scale)
    points = points.copy()
    points[:, :3] *= s
    if len(boxes):
        boxes = boxes.copy()
        boxes[:, :6] *= s
        if boxes.shape[-1] >= 9:
            boxes[:, 7:9] *= s
    return boxes, points


def global_translate(boxes, points, noise_std, rng):
    if np.all(np.asarray(noise_std) == 0):
        return boxes, points
    std = np.broadcast_to(np.asarray(noise_std, np.float64), (3,))
    t = rng.normal(0, std, size=3).astype(points.dtype)
    points = points.copy()
    points[:, :3] += t
    if len(boxes):
        boxes = boxes.copy()
        boxes[:, :3] += t
    return boxes, points
