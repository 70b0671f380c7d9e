"""Seeded SemanticKITTI-like frames, made in memory as the pipeline's file
loads would hand them on: an HDL-64E-like scan of 120,000-125,000 returns
(x, y, z, intensity), its labels in SemanticKITTI's raw ids (learning map
applied, as ``LoadPointCloudAnnotations`` does), the left colour camera's
1241x376 BGR image and each point's projection into it (KITTI odometry's
public P2 and Tr, as ``LoadPointCloudFromFile`` computes it).

The scan and image draws are a frozen copy of ``lidarseg3d_torch``'s
``synthetic._kitti_scan`` and ``_kitti_image`` (the trees the port's
evaluation phases were measured on), so the traffic stays as it is when
the program changes. The learning map is the semantic-kitti-api's.
"""

import numpy as np

HDL64_ELEVATION = np.linspace(2.0, -24.8, 64)
SENSOR_HEIGHT = 1.73
KITTI_P2 = np.array([[718.856, 0.0, 607.1928, 45.38225],
                     [0.0, 718.856, 185.2157, -0.1130887],
                     [0.0, 0.0, 1.0, 0.003779761]])
KITTI_TR = np.array(
    [[-1.857739e-03, -9.999659e-01, -8.039975e-03, -4.784029e-03],
     [-6.481465e-03, 8.051860e-03, -9.999466e-01, -7.337429e-02],
     [9.999773e-01, -1.805528e-03, -6.496203e-03, -3.339968e-01]])
GROUND_IDS = (40, 44, 48, 49, 60, 72)
STRUCTURE_IDS = (0, 1, 10, 11, 13, 15, 18, 20, 30, 31, 50, 51, 52, 70, 71,
                 80, 81, 99, 252, 253, 254)
THING_IDS = frozenset((10, 11, 13, 15, 18, 20, 30, 31, 252, 253, 254))
LEARNING_MAP = {
    0: 0, 1: 0, 10: 1, 11: 2, 13: 5, 15: 3, 16: 5, 18: 4, 20: 5, 30: 6,
    31: 7, 32: 8, 40: 9, 44: 10, 48: 11, 49: 12, 50: 13, 51: 14, 52: 0,
    60: 9, 70: 15, 71: 16, 72: 17, 80: 18, 81: 19, 99: 0, 252: 1, 253: 7,
    254: 6, 255: 8, 256: 5, 257: 5, 258: 4, 259: 5,
}
REMAP_LUT = np.zeros(max(LEARNING_MAP) + 1, np.int32)
for _raw, _train in LEARNING_MAP.items():
    REMAP_LUT[_raw] = _train
# the camera frustum the projection keeps (KITTI's image_2, 1224x370)
FRUSTUM_WH = (1224, 370)


def kitti_scan(rng, n, max_range, sectors=180, scene=None):
    """n returns of a 64-beam scanner: each beam hits the ground plane or,
    before it, the wall of its azimuth sector -> points [n, 4] float32,
    raw labels [n] uint32 (semantic id, instance id above bit 16). The
    walls' distances and classes are drawn from ``scene`` (a generator;
    ``rng`` when None), the returns from ``rng``."""
    scene = rng if scene is None else scene
    beam = rng.integers(0, 64, n)
    el = np.deg2rad(HDL64_ELEVATION[beam] + rng.normal(0.0, 0.05, n))
    az = rng.uniform(-np.pi, np.pi, n)
    sec = ((az + np.pi) / (2 * np.pi) * sectors).astype(np.int64) % sectors
    wall = scene.uniform(0.15, 0.98, sectors) * max_range
    ground_id = scene.choice(GROUND_IDS, sectors)
    wall_id = scene.choice(STRUCTURE_IDS, sectors)
    with np.errstate(divide="ignore"):
        d_ground = np.where(el < 0, SENSOR_HEIGHT / np.tan(-el), np.inf)
    on_ground = d_ground < wall[sec]
    d = np.where(on_ground, d_ground, wall[sec]) + rng.normal(0, 0.02, n)
    z = np.where(on_ground, -SENSOR_HEIGHT, d * np.tan(el))
    pts = np.stack([d * np.cos(az), d * np.sin(az),
                    z + rng.normal(0, 0.02, n), rng.uniform(0, 0.99, n)],
                   1).astype(np.float32)
    sem = np.where(on_ground, ground_id[sec], wall_id[sec]).astype(np.uint32)
    inst = np.where(np.isin(sem, list(THING_IDS)), sec + 1, 0)
    return pts, sem | (inst.astype(np.uint32) << 16)


def kitti_image(rng, H, W):
    """A smooth seeded BGR image with noise, uint8 [H, W, 3]."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    f = rng.uniform(0.005, 0.05, (3, 2)).astype(np.float32)
    ph = rng.uniform(0, 2 * np.pi, 3).astype(np.float32)
    img = np.stack([np.sin(xx * f[c, 0] + yy * f[c, 1] + ph[c])
                    for c in range(3)], -1)
    img = 127.5 + 110.0 * img + rng.normal(0, 8.0, (H, W, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def camera_projection(points):
    """Per point [cam_id, u, v]: cam_id 1 where the point projects into
    the frustum in front of the car, -100 in every column elsewhere."""
    proj = (KITTI_P2.astype(np.float32)
            @ np.vstack([KITTI_TR, [0, 0, 0, 1]]).astype(np.float32))
    hpts = np.concatenate(
        [points[:, :3], np.ones((len(points), 1), np.float32)], axis=1)
    img = (proj @ hpts.T).T
    img = img[:, :2] / np.maximum(img[:, 2:3], 1e-6)
    w, h = FRUSTUM_WH
    mask = ((img[:, 0] >= 0) & (img[:, 0] < w) & (img[:, 1] >= 0)
            & (img[:, 1] < h) & (points[:, 0] > 0))
    cp = np.full((len(points), 3), -100.0, np.float32)
    cp[mask, 0] = 1
    cp[mask, 1:3] = img[mask]
    return cp


def loaded_frame(rng, n, scene, max_range, cameras=(),
                 image_hw=(376, 1241), labels=True):
    """One frame of ``n`` returns in the walls of ``scene`` (a generator)
    as the file-loading stages leave it: ``points``, and with ``labels``
    the ``annotations``; with ``cameras`` also ``images`` (one BGR image a
    camera, the same frame image for each) and ``points_cp``."""
    pts, raw = kitti_scan(rng, n, max_range, scene=scene)
    sample = {"points": pts}
    if labels:
        sample["annotations"] = {
            "point_sem_labels": REMAP_LUT[(raw & 0xFFFF).astype(np.int64)],
            "point_inst_labels": (raw >> 16).astype(np.int32)}
    if cameras:
        img = kitti_image(rng, *image_hw)
        sample["images"] = [img for _ in cameras]
        sample["points_cp"] = camera_projection(pts)
    return sample
