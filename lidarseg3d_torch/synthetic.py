"""Model configs and synthetic inputs of the bench shapes (own copies of
``_mseg3d_model_cfg``, ``_synthetic_batch`` and ``_synthetic_mseg3d_batch``
from the repository's ``__graft_entry__.py``), plus the host->device
conversion of a collated batch.

The SemanticKITTI bench shape: point cloud range PCR at voxel size VSZ
gives the input spatial shape (Z, Y, X) = (21, 256, 256); one camera at
384x1280; V=131072 voxels and N=122880 points.

The semnusc bench shape (``SEMNUSC``, the JAX package's bench.py:155-175):
the 0.1 m nuScenes grid (Z, Y, X) = (41, 1024, 1024), six cameras at
640x960, V=N=40960, 17 classes, and the image branch in bf16.

``write_semantickitti_tree`` and ``write_semnusc_tree`` write a seeded
dataset on disk in SemanticKITTI's and nuScenes-lidarseg's layouts, and
``write_eval_config`` a config whose splits read it, for the evaluation
and training entry points; ``write_mini_segnet_config`` cuts a published
SegNet config (SDSeg3D, the MSeg3D lidar-only baselines) to a mini model
over such a tree, ``write_mini_polar_config`` a published SegPolarNet
config (Cylinder3D, its _v2p variant, PolarNet) over a nuScenes tree.
``write_semanticwaymo_tree`` writes converted SemanticWaymo frames (the
TOP and short-range lidars, five cameras) and their infos. Both the
nuScenes and the Waymo writers add labelled boxes on request (``boxes``;
nuScenes also ``sweeps``), and ``write_mini_det_config`` cuts a published
detection config (VoxelNet, PointPillars) to a mini model over such a
tree.
``segnet_model_cfg`` is SDSeg3D's model at its published widths.
"""

import json
import os
import pickle

import numpy as np
import torch

from .core.voxelize import VoxelGenerator, encode_compact_value_labels
from .datasets.batching import collate_segnet
from .datasets.nuscenes.metadata import CAM_CHANS
from .datasets.pipelines.jpeg_read import encode_jpeg_bgr, write_jpeg_bgr
from .datasets.pipelines.png import write_png_bgr

PCR = (-25.6, -25.6, -4.0, 25.6, 25.6, 2.0)
VSZ = (0.2, 0.2, 0.3)
SEMNUSC = dict(pcr=(-51.2, -51.2, -5.0, 51.2, 51.2, 3.0), vsz=(0.1, 0.1, 0.2),
               V=40960, N=40960, ncam=6, img_hw=(640, 960), num_class=17)


def grid_shape(pcr=None, vsz=None):
    """(Z, Y, X) input spatial shape: Z gets one extra slab, as in the
    JAX package's bench."""
    pcr = pcr or PCR
    vsz = vsz or VSZ
    grid = np.round((np.asarray(pcr[3:]) - np.asarray(pcr[:3]))
                    / np.asarray(vsz)).astype(int)
    return (int(grid[2]) + 1, int(grid[1]), int(grid[0]))


def synthetic_batch(B, V, N, P=5, seed=0, with_labels=False, pcr=None,
                    vsz=None):
    """Plausible LiDAR scan: ground plane + clutter, voxelized on host.
    ``with_labels`` draws a class in [0, 20) per point and adds
    ``point_sem_labels`` and ``voxel_sem_labels`` (the single label of a
    voxel's points, else the ignored label 0)."""
    pcr = list(pcr or PCR)
    vsz = list(vsz or VSZ)
    r = 0.98 * min(-pcr[0], pcr[3])
    rng = np.random.default_rng(seed)
    vg = VoxelGenerator(vsz, pcr, max_num_points=P, max_voxels=V)
    frames = []
    for _ in range(B):
        n = N
        ground = np.stack([
            rng.uniform(-r, r, n // 2), rng.uniform(-r, r, n // 2),
            rng.normal(-1.6, 0.05, n // 2), rng.uniform(0, 1, n // 2),
        ], 1)
        objs = np.stack([
            rng.normal(5, r / 3, n - n // 2), rng.normal(-3, r / 3, n - n // 2),
            rng.uniform(-1.5, 1.5, n - n // 2), rng.uniform(0, 1, n - n // 2),
        ], 1)
        pts = np.concatenate([ground, objs]).astype(np.float32)
        src = pts
        if with_labels:
            labels = rng.integers(0, 20, size=n).astype(np.int32)
            src = np.concatenate(
                [pts, labels[:, None].astype(np.float32) + 1], 1)
        voxels, coords, npts = vg.generate(src)
        fr = {"voxels": voxels[:, :, :4], "coordinates": coords,
              "num_points_per_voxel": npts, "points": pts}
        if with_labels:
            fr["voxel_sem_labels"] = encode_compact_value_labels(
                voxels[:, :, 4].astype(np.int64)).astype(np.int32)
            fr["point_sem_labels"] = labels
        frames.append(fr)
    return collate_segnet(frames, max_voxels=V, max_points=N)


def mseg3d_model_cfg(num_class=20, ratio=2, img_hw=(384, 1280),
                     small_hrnet=False, pcr=None, vsz=None, img_bf16=False):
    """MSeg3D flagship: ImprovedMeanVFE + UNetSCN3D(r) + HRNet-w18 + FCN
    head + fusion head. ``small_hrnet`` keeps the w18 widths with one
    module / one block per stage (for small tests); ``img_bf16`` runs
    HRNet and the FCN head with bf16 activations (fp32 parameters, BN and
    outputs). ``img_hw`` is unused, as in the JAX package's signature."""
    if small_hrnet:
        extra = dict(
            stage1=dict(num_modules=1, num_branches=1, block="BOTTLENECK",
                        num_blocks=(1,), num_channels=(16,)),
            stage2=dict(num_modules=1, num_branches=2, block="BASIC",
                        num_blocks=(1, 1), num_channels=(18, 36)),
            stage3=dict(num_modules=1, num_branches=3, block="BASIC",
                        num_blocks=(1, 1, 1), num_channels=(18, 36, 72)),
            stage4=dict(num_modules=1, num_branches=4, block="BASIC",
                        num_blocks=(1, 1, 1, 1),
                        num_channels=(18, 36, 72, 144)),
        )
    else:
        extra = dict(
            stage1=dict(num_modules=1, num_branches=1, block="BOTTLENECK",
                        num_blocks=(4,), num_channels=(64,)),
            stage2=dict(num_modules=1, num_branches=2, block="BASIC",
                        num_blocks=(4, 4), num_channels=(18, 36)),
            stage3=dict(num_modules=4, num_branches=3, block="BASIC",
                        num_blocks=(4, 4, 4), num_channels=(18, 36, 72)),
            stage4=dict(num_modules=3, num_branches=4, block="BASIC",
                        num_blocks=(4, 4, 4, 4),
                        num_channels=(18, 36, 72, 144)),
        )
    pcr = list(pcr or PCR)
    vsz = list(vsz or VSZ)
    bf16 = {"compute_dtype": "bfloat16"} if img_bf16 else {}
    return dict(
        type="SegMSeg3DNet",
        img_backbone=dict(type="HRNet", extra=extra, **bf16),
        img_head=dict(
            type="FCNMSeg3DHead", num_classes=num_class, ignore_index=0,
            in_index=(0, 1, 2, 3), in_channels=(18, 36, 72, 144),
            num_convs=2, channels=48, concat_input=False, loss_weight=0.5,
            **bf16,
        ),
        reader=dict(type="ImprovedMeanVoxelFeatureExtractor",
                    num_input_features=4),
        backbone=dict(
            type="UNetSCN3D", num_input_features=12, ds_factor=8,
            us_factor=8, point_cloud_range=pcr, voxel_size=vsz,
            model_cfg=dict(SCALING_RATIO=ratio),
        ),
        point_head=dict(
            type="PointSegMSeg3DHead", class_agnostic=False,
            num_class=num_class,
            model_cfg=dict(
                VOXEL_IN_DIM=16 * ratio, VOXEL_CLS_FC=[64],
                VOXEL_ALIGN_DIM=64, IMAGE_IN_DIM=48, IMAGE_ALIGN_DIM=64,
                GEO_FUSED_DIM=64, OUT_CLS_FC=[64, 64], IGNORED_LABEL=0,
                DP_RATIO=0.25, MIMIC_FC=[64, 64],
                SFPhase_CFG=dict(
                    embeddings_proj_kernel_size=1, d_model=96, n_head=4,
                    n_layer=6, n_ffn=192, drop_ratio=0, activation="relu",
                    pre_norm=False,
                ),
            ),
        ),
    )


def segnet_model_cfg(num_class=20, ratio=2, pcr=None, vsz=None,
                     num_input_features=4, reader="transvfe"):
    """SDSeg3D (configs/semantickitti/SDSeg3D/
    semkitti_transVFE_unetscn3d_batchloss_e10.py): TransVFE (3 layers,
    embedding 64, 4 heads, 16 compressed features) + UNetSCN3D(r) + the
    batch-loss head; ``reader="improved_mean"`` gives the MSeg3D papers'
    lidar-only baseline (ImprovedMeanVFE, whose descriptor feeds the
    backbone)."""
    if reader == "transvfe":
        rd = dict(type="TransformerVoxelFeatureExtractor",
                  num_input_features=num_input_features,
                  num_compressed_features=16, num_embed=64, num_head=4,
                  num_layers=3)
        c_in = 16
    else:
        rd = dict(type="ImprovedMeanVoxelFeatureExtractor",
                  num_input_features=num_input_features)
        c_in = num_input_features + 8
    return dict(
        type="SegNet", pretrained=None, reader=rd,
        backbone=dict(type="UNetSCN3D", num_input_features=c_in, ds_factor=8,
                      us_factor=8, point_cloud_range=list(pcr or PCR),
                      voxel_size=list(vsz or VSZ),
                      model_cfg=dict(SCALING_RATIO=ratio,
                                     DOWN_CAPACITY_RATIOS=(0.5, 0.25, 0.15))),
        point_head=dict(type="PointSegBatchlossHead", class_agnostic=False,
                        num_class=num_class,
                        model_cfg=dict(CONV_IN_DIM=16 * ratio,
                                       CONV_CLS_FC=[64], CONV_ALIGN_DIM=64,
                                       OUT_CLS_FC=[64, 64], IGNORED_LABEL=0)))


def synthetic_mseg3d_batch(B, V, N, img_hw=(384, 1280), ncam=1, seed=0,
                           with_labels=False, pcr=None, vsz=None):
    """SegNet batch + synthetic camera images and point->pixel projections
    (+ ``images_sem_labels`` [B*ncam, H, W] with ``with_labels``)."""
    rng = np.random.default_rng(seed)
    batch = synthetic_batch(B, V, N, seed=seed, with_labels=with_labels,
                            pcr=pcr, vsz=vsz)
    H, W = img_hw
    batch["images"] = rng.uniform(
        -2, 2, size=(B, ncam, H, W, 3)).astype(np.float32)
    Np = batch["points"].shape[1]
    cuv = np.zeros((B, Np, 4), np.float32)
    cuv[:, :, 0] = (rng.random((B, Np)) < 0.55).astype(np.float32)  # in view
    if ncam > 1:
        # normalized cam index (align_corners=True): cam k -> 2k/(ncam-1)-1
        cam = rng.integers(0, ncam, (B, Np)).astype(np.float32)
        cuv[:, :, 1] = 2.0 * cam / (ncam - 1) - 1.0
    cuv[:, :, 2] = rng.uniform(-1, 1, (B, Np))  # norm v
    cuv[:, :, 3] = rng.uniform(-1, 1, (B, Np))  # norm u
    batch["points_cuv"] = cuv
    if with_labels:
        batch["images_sem_labels"] = rng.integers(
            0, 20, size=(B * ncam, H, W)).astype(np.int32)
    return batch


def example_to_device(batch, device, input_shape=None):
    """Collated numpy batch -> dict of tensors on ``device`` (metadata
    dropped), with the static ``input_shape`` (Z, Y, X) attached when one
    is given."""
    ex = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
          for k, v in batch.items() if k != "metadata"}
    if input_shape is not None:
        ex["input_shape"] = tuple(int(s) for s in input_shape)
    return ex


# HDL-64E beam elevations (degrees), the sensor's height over the ground
# (m), and KITTI's left colour camera P2 and velodyne->camera Tr of the
# public odometry calibration
HDL64_ELEVATION = np.linspace(2.0, -24.8, 64)
SENSOR_HEIGHT = 1.73
KITTI_P2 = np.array([[718.856, 0.0, 607.1928, 45.38225],
                     [0.0, 718.856, 185.2157, -0.1130887],
                     [0.0, 0.0, 1.0, 0.003779761]])
KITTI_TR = np.array(
    [[-1.857739e-03, -9.999659e-01, -8.039975e-03, -4.784029e-03],
     [-6.481465e-03, 8.051860e-03, -9.999466e-01, -7.337429e-02],
     [9.999773e-01, -1.805528e-03, -6.496203e-03, -3.339968e-01]])
# raw label ids: what the ground and the structures around it are made of
GROUND_IDS = (40, 44, 48, 49, 60, 72)
STRUCTURE_IDS = (0, 1, 10, 11, 13, 15, 18, 20, 30, 31, 50, 51, 52, 70, 71,
                 80, 81, 99, 252, 253, 254)
THING_IDS = frozenset((10, 11, 13, 15, 18, 20, 30, 31, 252, 253, 254))


def _kitti_scan(rng, n, max_range, sectors=180):
    """n returns of a 64-beam scanner: each beam hits the ground plane or,
    before it, the wall of its azimuth sector (at a seeded distance up to
    ``max_range``). -> points [n, 4] float32, raw labels [n] uint32 (the
    semantic id in the low 16 bits, an instance id above for things)."""
    beam = rng.integers(0, 64, n)
    el = np.deg2rad(HDL64_ELEVATION[beam] + rng.normal(0.0, 0.05, n))
    az = rng.uniform(-np.pi, np.pi, n)
    sec = ((az + np.pi) / (2 * np.pi) * sectors).astype(np.int64) % sectors
    wall = rng.uniform(0.15, 0.98, sectors) * max_range
    ground_id = rng.choice(GROUND_IDS, sectors)
    wall_id = rng.choice(STRUCTURE_IDS, sectors)
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


def _kitti_image(rng, H, W):
    """A smooth seeded BGR image with noise, uint8 [H, W, 3]."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    f = rng.uniform(0.005, 0.05, (3, 2)).astype(np.float32)
    ph = rng.uniform(0, 2 * np.pi, 3).astype(np.float32)
    img = np.stack([np.sin(xx * f[c, 0] + yy * f[c, 1] + ph[c])
                    for c in range(3)], -1)
    img = 127.5 + 110.0 * img + rng.normal(0, 8.0, (H, W, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def write_semantickitti_tree(root, sequences=("08",), frames=4,
                             points=(120000, 125000), seed=0,
                             with_images=True, image_hw=(376, 1241),
                             max_range=75.0):
    """Write a seeded tree in SemanticKITTI's layout under ``root`` (the
    ``sequences`` directory): per sequence a calib.txt with P0-P3 and Tr,
    and per frame ``velodyne/NNNNNN.bin`` (float32 x, y, z, intensity),
    ``labels/NNNNNN.label`` (uint32 raw ids from the learning map, with
    instance bits) and, ``with_images``, ``image_2/NNNNNN.png`` (8-bit RGB,
    ``image_hw``). ``points`` is a frame's point count, or an inclusive
    (low, high) range to draw it from. The scans are rings of a 64-beam
    scanner within ``max_range`` m; about a fifth of the points fall in
    the camera's view."""
    rng = np.random.default_rng(seed)
    lo, hi = (points, points) if np.isscalar(points) else points
    calib = "".join(f"P{i}: " + " ".join(f"{v:.12e}" for v in
                                         KITTI_P2.reshape(-1)) + "\n"
                    for i in range(4))
    calib += "Tr: " + " ".join(f"{v:.12e}" for v in KITTI_TR.reshape(-1))
    for seq in sequences:
        base = os.path.join(root, seq)
        for sub in ("velodyne", "labels") + (("image_2",) if with_images
                                            else ()):
            os.makedirs(os.path.join(base, sub), exist_ok=True)
        with open(os.path.join(base, "calib.txt"), "w") as f:
            f.write(calib + "\n")
        for i in range(frames):
            n = int(rng.integers(lo, hi + 1))
            pts, raw = _kitti_scan(rng, n, max_range)
            pts.tofile(os.path.join(base, "velodyne", f"{i:06d}.bin"))
            raw.tofile(os.path.join(base, "labels", f"{i:06d}.label"))
            if with_images:
                write_png_bgr(os.path.join(base, "image_2", f"{i:06d}.png"),
                              _kitti_image(rng, *image_hw))


# nuScenes' rig: HDL-32E beam elevations (degrees), LIDAR_TOP's mount
# (translation on the ego, yaw), and each camera's mount and intrinsics
# (the published calibration's values, rounded; camera axes x right, y
# down, z forward)
HDL32_ELEVATION = np.linspace(10.67, -30.67, 32)
NUSC_LIDAR = dict(translation=(0.94, 0.0, 1.84), yaw=-90.0)
NUSC_CAMS = {
    "CAM_FRONT": ((1.70, 0.00, 1.51), 0.0, (1266.4, 816.3, 491.5)),
    "CAM_FRONT_RIGHT": ((1.55, -0.49, 1.49), -55.0, (1260.8, 807.9, 495.3)),
    "CAM_BACK_RIGHT": ((1.03, -0.48, 1.57), -110.0, (1256.7, 792.1, 492.8)),
    "CAM_BACK": ((0.03, 0.00, 1.58), 180.0, (809.2, 829.2, 481.8)),
    "CAM_BACK_LEFT": ((1.05, 0.48, 1.57), 110.0, (1256.7, 817.8, 451.9)),
    "CAM_FRONT_LEFT": ((1.52, 0.49, 1.51), 55.0, (1272.6, 826.6, 479.8)),
}
# raw lidarseg ids (0-31): ground classes, and what stands on the ground
NUSC_GROUND_IDS = (24, 25, 26, 27)
NUSC_STRUCTURE_IDS = (0, 1, 2, 9, 12, 14, 15, 17, 18, 21, 22, 23, 28, 30)


def _quaternion(R):
    """[w, x, y, z] of a 3x3 rotation matrix (w >= 0)."""
    w = np.sqrt(max(0.0, 1.0 + R[0, 0] + R[1, 1] + R[2, 2])) / 2
    x = np.sqrt(max(0.0, 1.0 + R[0, 0] - R[1, 1] - R[2, 2])) / 2
    y = np.sqrt(max(0.0, 1.0 - R[0, 0] + R[1, 1] - R[2, 2])) / 2
    z = np.sqrt(max(0.0, 1.0 - R[0, 0] - R[1, 1] + R[2, 2])) / 2
    x = np.copysign(x, R[2, 1] - R[1, 2])
    y = np.copysign(y, R[0, 2] - R[2, 0])
    z = np.copysign(z, R[1, 0] - R[0, 1])
    return [float(w), float(x), float(y), float(z)]


def _yaw_quaternion(deg):
    h = np.deg2rad(deg) / 2
    return [float(np.cos(h)), 0.0, 0.0, float(np.sin(h))]


def _camera_quaternion(yaw):
    """Rotation camera -> ego of a camera looking along ``yaw`` degrees."""
    a = np.deg2rad(yaw)
    fwd = np.array([np.cos(a), np.sin(a), 0.0])
    right = np.array([np.sin(a), -np.cos(a), 0.0])
    return _quaternion(np.stack([right, [0.0, 0.0, -1.0], fwd], 1))


def _nusc_scan(rng, n, max_range):
    """n returns of a 32-beam scanner at LIDAR_TOP's height: each beam hits
    the ground or, before it, the wall of its azimuth sector. -> float32
    [n, 5] rows (x, y, z, intensity, ring) and uint8 raw lidarseg ids."""
    sectors = 240
    beam = rng.integers(0, 32, n)
    el = np.deg2rad(HDL32_ELEVATION[beam] + rng.normal(0.0, 0.05, n))
    az = rng.uniform(-np.pi, np.pi, n)
    sec = ((az + np.pi) / (2 * np.pi) * sectors).astype(np.int64) % sectors
    wall = rng.uniform(0.1, 0.98, sectors) * max_range
    ground_id = rng.choice(NUSC_GROUND_IDS, sectors)
    wall_id = rng.choice(NUSC_STRUCTURE_IDS, sectors)
    height = NUSC_LIDAR["translation"][2]
    with np.errstate(divide="ignore"):
        d_ground = np.where(el < 0, height / np.tan(-el), np.inf)
    on_ground = d_ground < wall[sec]
    d = np.where(on_ground, d_ground, wall[sec]) + rng.normal(0, 0.02, n)
    z = np.where(on_ground, -height, d * np.tan(el))
    pts = np.stack([d * np.cos(az), d * np.sin(az),
                    z + rng.normal(0, 0.02, n), rng.uniform(0, 100, n),
                    beam], 1).astype(np.float32)
    sem = np.where(on_ground, ground_id[sec], wall_id[sec]).astype(np.uint8)
    return pts, sem


# nuScenes detection class -> (category name, raw lidarseg id) and (w, l,
# h) in metres
NUSC_DET_CATEGORIES = {
    "car": ("vehicle.car", 17), "truck": ("vehicle.truck", 23),
    "construction_vehicle": ("vehicle.construction", 18),
    "bus": ("vehicle.bus.rigid", 16), "trailer": ("vehicle.trailer", 22),
    "barrier": ("movable_object.barrier", 9),
    "motorcycle": ("vehicle.motorcycle", 21),
    "bicycle": ("vehicle.bicycle", 14),
    "pedestrian": ("human.pedestrian.adult", 2),
    "traffic_cone": ("movable_object.trafficcone", 12),
}
NUSC_DET_SIZES = {
    "car": (1.9, 4.6, 1.7), "truck": (2.5, 7.0, 3.0),
    "construction_vehicle": (2.8, 6.5, 3.2), "bus": (2.9, 11.0, 3.5),
    "trailer": (2.3, 12.0, 3.8), "barrier": (2.5, 0.5, 1.0),
    "motorcycle": (0.8, 2.1, 1.5), "bicycle": (0.6, 1.7, 1.3),
    "pedestrian": (0.7, 0.7, 1.8), "traffic_cone": (0.4, 0.4, 1.0),
}


def _points_in_box(rng, box, n):
    """n points drawn uniformly inside the box [x, y, z, l, w, h, yaw]
    (z its centre) -> float32 [n, 3]."""
    local = (rng.uniform(-0.45, 0.45, (n, 3)) * np.asarray(box[3:6]))
    c, s = np.cos(box[6]), np.sin(box[6])
    x = local[:, 0] * c - local[:, 1] * s + box[0]
    y = local[:, 0] * s + local[:, 1] * c + box[1]
    return np.stack([x, y, local[:, 2] + box[2]], 1).astype(np.float32)


def _nusc_object(rng, name, max_range, token):
    """A detection object of class ``name``: its lidar-frame centre and
    yaw at the scene's first sample, size and global velocity."""
    w, l, h = (v * rng.uniform(0.9, 1.1) for v in NUSC_DET_SIZES[name])
    r = rng.uniform(5.0, 0.6 * max_range)
    a = rng.uniform(-np.pi, np.pi)
    moving = name not in ("barrier", "traffic_cone")
    v = rng.uniform(-3.0, 3.0, 2) if moving else np.zeros(2)
    z = -NUSC_LIDAR["translation"][2] + h / 2  # standing on the ground
    return dict(name=name, token=token, l=l, w=w, h=h,
                yaw=rng.uniform(-np.pi, np.pi),
                center=np.array([r * np.cos(a), r * np.sin(a), z]),
                velocity=np.array([v[0], v[1], 0.0]))


def _nusc_lidar_to_global(pos, heading):
    """-> f: the LIDAR_TOP frame -> global of an ego at ``pos`` with
    ``heading`` degrees; f() the 4x4 matrix, f(p) the point p."""
    def rot(deg):
        a = np.deg2rad(deg)
        R = np.eye(4)
        R[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
        return R

    ego = rot(heading)
    ego[:2, 3] = pos
    cs = rot(NUSC_LIDAR["yaw"])
    cs[:3, 3] = NUSC_LIDAR["translation"]
    T = ego @ cs

    def f(p=None):
        return T if p is None else (T @ np.append(p, 1.0))[:3]

    return f


def write_semnusc_tree(root, scenes=("scene-0003",), samples=2,
                       points=(30000, 34688), seed=0, cams=CAM_CHANS,
                       max_range=50.0, quality=95,
                       version="v1.0-trainval", boxes=0, sweeps=0,
                       sweep_points=None):
    """Write a seeded nuScenes-lidarseg tree under ``root``: the tables
    (``sample``, ``sample_data``, ``scene``, ``calibrated_sensor``,
    ``ego_pose``, ``sensor``, ``lidarseg``; ``sample_annotation``,
    ``instance`` and ``category`` empty) in ``root/version``, and per
    sample a LIDAR_TOP ``samples/LIDAR_TOP/*.pcd.bin`` scan (float32 x, y,
    z, intensity, ring; ``points`` returns, or an inclusive (low, high)
    range to draw the count from, of a 32-beam scanner within
    ``max_range`` m), its uint8 ``lidarseg/version/*_lidarseg.bin`` file
    over the 32 raw classes, and a 1600x900 JPEG (``write_jpeg_bgr`` at
    ``quality``) for each camera channel in ``cams``. ``scenes`` names
    scenes of the official lists (their split decides train or val),
    each of ``samples`` key frames 0.5 s apart along the ego's path;
    each key frame's LIDAR_TOP record links to the previous one as its
    sweep. The cameras keep nuScenes' mounts and intrinsics, so each sees
    a share of the points.

    Detection (drawn from a generator of their own, so a tree without
    them is the same): ``boxes`` objects per scene, of the ten nuScenes
    detection classes in turn, fill ``sample_annotation``, ``instance``
    and ``category``: each keeps its heading and moves at its own speed
    across the scene's samples (so its velocity is defined), and each
    sample's scan gets 20-80 returns inside each box (``num_lidar_pts``,
    so the infos keep it). ``sweeps`` non-key LIDAR_TOP scans of
    ``sweep_points`` returns (default: the key frames' low count) 0.05 s
    apart come before each key frame in its ``prev`` chain, the sweeps a
    multi-sweep config reads."""
    rng = np.random.default_rng(seed)
    xrng = np.random.default_rng([seed, 1])  # boxes and sweeps only
    lo, hi = (points, points) if np.isscalar(points) else points
    for sub in ["samples/LIDAR_TOP", f"lidarseg/{version}", version] + [
            f"samples/{c}" for c in cams]:
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    tables = {t: [] for t in ("sample", "sample_data", "scene",
                              "calibrated_sensor", "ego_pose", "sensor",
                              "lidarseg", "sample_annotation", "instance",
                              "category")}
    tables["sensor"].append(dict(token="sensor_LIDAR_TOP",
                                 channel="LIDAR_TOP", modality="lidar"))
    tables["calibrated_sensor"].append(dict(
        token="cs_LIDAR_TOP", sensor_token="sensor_LIDAR_TOP",
        translation=list(NUSC_LIDAR["translation"]),
        rotation=_yaw_quaternion(NUSC_LIDAR["yaw"]), camera_intrinsic=[]))
    for c in cams:
        t, yaw, (f, cx, cy) = NUSC_CAMS[c]
        tables["sensor"].append(dict(token=f"sensor_{c}", channel=c,
                                     modality="camera"))
        tables["calibrated_sensor"].append(dict(
            token=f"cs_{c}", sensor_token=f"sensor_{c}", translation=list(t),
            rotation=_camera_quaternion(yaw),
            camera_intrinsic=[[f, 0.0, cx], [0.0, f, cy], [0.0, 0.0, 1.0]]))
    for c in NUSC_DET_CATEGORIES.values():
        tables["category"].append(dict(token=f"cat_{c[0]}", name=c[0]))
    det_names = list(NUSC_DET_CATEGORIES)
    for si, name in enumerate(scenes):
        toks = [f"{name}_s{i}" for i in range(samples)]
        heading = rng.uniform(-180.0, 180.0)
        start = rng.uniform(-500.0, 500.0, 2)
        a = np.deg2rad(heading)
        fwd = np.array([np.cos(a), np.sin(a)])
        objs = [_nusc_object(xrng, det_names[j % len(det_names)],
                             max_range, f"inst_{name}_{j}")
                for j in range(boxes)]
        for o in objs:
            tables["instance"].append(dict(
                token=o["token"],
                category_token=f"cat_{NUSC_DET_CATEGORIES[o['name']][0]}"))
        sensor_yaw = heading + NUSC_LIDAR["yaw"]
        for i, tok in enumerate(toks):
            stamp = (si + 1) * 10**8 + i * 500000
            pos = start + 2.5 * i * fwd
            tables["ego_pose"].append(dict(
                token=f"ep_{tok}", timestamp=stamp,
                translation=[float(pos[0]), float(pos[1]), 0.0],
                rotation=_yaw_quaternion(heading)))
            lidar_sd = f"sd_{tok}_LIDAR_TOP"
            n = int(rng.integers(lo, hi + 1))
            pts, sem = _nusc_scan(rng, n, max_range)
            to_global = _nusc_lidar_to_global(pos, heading)
            extra, extra_sem = [], []
            for j, o in enumerate(objs):
                # the box in this sample's lidar frame, from its global
                # pose at time 0.5 i s
                if i == 0:
                    o["start"] = to_global(o["center"])
                g = o["start"] + 0.5 * i * o["velocity"]
                c = np.linalg.inv(to_global()) @ np.append(g, 1.0)
                box = np.array([c[0], c[1], c[2], o["l"], o["w"], o["h"],
                                o["yaw"]])
                k = int(xrng.integers(20, 81))
                bp = _points_in_box(xrng, box, k)
                extra.append(np.concatenate([bp, np.stack(
                    [xrng.uniform(0, 100, k), np.full(k, 16.0)], 1)], 1))
                extra_sem.append(np.full(k, NUSC_DET_CATEGORIES[
                    o["name"]][1], np.uint8))
                ann = f"ann_{o['token']}_{i}"
                tables["sample_annotation"].append(dict(
                    token=ann, sample_token=tok, instance_token=o["token"],
                    translation=[float(v) for v in g],
                    size=[float(o["w"]), float(o["l"]), float(o["h"])],
                    rotation=_yaw_quaternion(np.rad2deg(o["yaw"])
                                             + sensor_yaw),
                    prev=f"ann_{o['token']}_{i - 1}" if i else "",
                    next=(f"ann_{o['token']}_{i + 1}" if i + 1 < samples
                          else ""),
                    num_lidar_pts=k, num_radar_pts=0))
            if extra:
                pts = np.concatenate([pts] + extra).astype(np.float32)
                sem = np.concatenate([sem] + extra_sem)
            lidar_file = f"samples/LIDAR_TOP/{tok}.pcd.bin"
            seg_file = f"lidarseg/{version}/{lidar_sd}_lidarseg.bin"
            pts.tofile(os.path.join(root, lidar_file))
            sem.tofile(os.path.join(root, seg_file))
            tables["lidarseg"].append(dict(token=f"seg_{tok}",
                                           sample_data_token=lidar_sd,
                                           filename=seg_file))
            data = {"LIDAR_TOP": lidar_sd}
            sw_lo = lo if sweep_points is None else sweep_points
            prev_key = f"sd_{toks[i - 1]}_LIDAR_TOP" if i else ""
            for j in range(sweeps):
                sw = f"sd_{tok}_LIDAR_TOP_sw{j}"
                back = (sweeps - j) * 0.05
                sw_stamp = stamp - int(back * 1e6)
                sw_pos = pos - 5.0 * back * fwd
                tables["ego_pose"].append(dict(
                    token=f"ep_{sw}", timestamp=sw_stamp,
                    translation=[float(sw_pos[0]), float(sw_pos[1]), 0.0],
                    rotation=_yaw_quaternion(heading)))
                sw_file = f"sweeps/LIDAR_TOP/{tok}_sw{j}.pcd.bin"
                os.makedirs(os.path.join(root, "sweeps/LIDAR_TOP"),
                            exist_ok=True)
                _nusc_scan(xrng, sw_lo, max_range)[0].tofile(
                    os.path.join(root, sw_file))
                tables["sample_data"].append(dict(
                    token=sw, sample_token=tok, filename=sw_file,
                    calibrated_sensor_token="cs_LIDAR_TOP",
                    ego_pose_token=f"ep_{sw}", timestamp=sw_stamp,
                    is_key_frame=False,
                    prev=f"sd_{tok}_LIDAR_TOP_sw{j - 1}" if j else prev_key,
                    next=(f"sd_{tok}_LIDAR_TOP_sw{j + 1}" if j + 1 < sweeps
                          else lidar_sd)))
            for c in ["LIDAR_TOP"] + list(cams):
                sd = f"sd_{tok}_{c}"
                fname = lidar_file if c == "LIDAR_TOP" \
                    else f"samples/{c}/{tok}.jpg"
                if c != "LIDAR_TOP":
                    write_jpeg_bgr(os.path.join(root, fname),
                                   _kitti_image(rng, 900, 1600), quality)
                    data[c] = sd
                lidar_sweeps = c == "LIDAR_TOP" and sweeps
                prev = f"sd_{toks[i - 1]}_{c}" if i else ""
                nxt = f"sd_{toks[i + 1]}_{c}" if i + 1 < samples else ""
                if lidar_sweeps:
                    prev = f"sd_{tok}_LIDAR_TOP_sw{sweeps - 1}"
                    nxt = (f"sd_{toks[i + 1]}_LIDAR_TOP_sw0"
                           if i + 1 < samples else "")
                tables["sample_data"].append(dict(
                    token=sd, sample_token=tok, filename=fname,
                    calibrated_sensor_token=f"cs_{c}",
                    ego_pose_token=f"ep_{tok}", timestamp=stamp,
                    is_key_frame=True, prev=prev, next=nxt))
            tables["sample"].append(dict(
                token=tok, timestamp=stamp, scene_token=f"scene_{name}",
                data=data, prev=toks[i - 1] if i else "",
                next=toks[i + 1] if i + 1 < samples else ""))
        tables["scene"].append(dict(
            token=f"scene_{name}", name=name, nbr_samples=samples,
            first_sample_token=toks[0], last_sample_token=toks[-1]))
    for t, rows in tables.items():
        with open(os.path.join(root, version, f"{t}.json"), "w") as f:
            json.dump(rows, f)


# Waymo's rig: the TOP lidar (64 beams from +2.4 to -17.6 degrees, 2650
# columns, 75 m), the four short-range lidars (mount, yaw; 20 m), and the
# five cameras (name id: mount, yaw, published image size W x H); vehicle
# frame x forward, y left, z up from the ground
WAYMO_TOP = dict(height=2.18, rows=64, cols=2650, max_range=75.0,
                 elevation=np.linspace(2.4, -17.6, 64))
WAYMO_SHORT = {"FRONT": ((4.07, 0.0, 0.69), 0.0),
               "SIDE_LEFT": ((3.25, 1.02, 0.98), 90.0),
               "SIDE_RIGHT": ((3.25, -1.02, 0.98), -90.0),
               "REAR": ((-1.15, 0.0, 0.47), 180.0)}
WAYMO_CAMS = {"1": ((1.54, -0.02, 2.12), 0.0, (1920, 1280)),
              "2": ((1.50, 0.09, 2.12), 45.0, (1920, 1280)),
              "3": ((1.50, -0.11, 2.12), -45.0, (1920, 1280)),
              "4": ((1.43, 0.10, 2.12), 90.0, (1920, 886)),
              "5": ((1.43, -0.12, 2.12), -90.0, (1920, 886))}
WAYMO_FOCAL = 2055.0  # pixels at 1920 columns
# Waymo seg classes: the ground, and what stands on it (0 = undefined)
WAYMO_GROUND_IDS = (17, 18, 19, 20, 21, 22)
WAYMO_STRUCTURE_IDS = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14,
                       15, 16)


def _waymo_hits(rng, origin, az, el, walls, max_range):
    """Distances, hit mask and labels of rays from ``origin`` (x, y, z)
    at azimuths ``az`` and elevations ``el`` (radians): each ray ends on
    the ground (z = 0) or, before it, on the wall of its azimuth sector
    (``walls``: distance, height, ground id, wall id per sector, around
    the vehicle's origin), within ``max_range``."""
    dist, height, gid, wid = walls
    sectors = len(dist)
    sec = ((az + np.pi) / (2 * np.pi) * sectors).astype(np.int64) % sectors
    with np.errstate(divide="ignore"):
        d_ground = np.where(el < 0, origin[2] / np.tan(-el), np.inf)
    d_wall = np.maximum(dist[sec] - np.hypot(origin[0], origin[1]), 0.5)
    z_wall = origin[2] + d_wall * np.tan(el)
    on_ground = d_ground < d_wall
    d = np.where(on_ground, d_ground, d_wall)
    hit = (d < max_range) & (on_ground | (z_wall < height[sec]))
    lab = np.where(on_ground, gid[sec], wid[sec])
    # rough surfaces: grass, kerbs and foliage scatter the returns
    return d + rng.normal(0, 0.15, d.shape), hit, lab


def _waymo_points_cp(xyz, cam_hw):
    """[cam_id, w, h] of each point in the first of the five cameras that
    sees it (in that camera's own pixels, the image ``cam_hw[cam]``
    (W, H)), -100 where none does."""
    cp = np.full((len(xyz), 3), -100.0, np.float32)
    free = np.ones(len(xyz), bool)
    for cam, (pos, yaw, _) in WAYMO_CAMS.items():
        W, H = cam_hw[cam]
        f = WAYMO_FOCAL * W / 1920.0
        a = np.deg2rad(yaw)
        p = xyz - np.asarray(pos)
        fwd = p[:, 0] * np.cos(a) + p[:, 1] * np.sin(a)
        right = p[:, 0] * np.sin(a) - p[:, 1] * np.cos(a)
        with np.errstate(divide="ignore", invalid="ignore"):
            u = f * right / fwd + W / 2.0
            v = f * -p[:, 2] / fwd + H / 2.0
        sees = free & (fwd > 0.1) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
        cp[sees] = np.stack([np.full(sees.sum(), float(cam)), u[sees],
                             v[sees]], 1)
        free &= ~sees
    return cp


def _waymo_frame(rng, second_return, short_points, cam_hw, cols,
                 max_range):
    """One converted frame's arrays: the TOP lidar's first returns, its
    second returns, then the short-range lidars' returns."""
    top = dict(WAYMO_TOP, cols=cols, max_range=max_range)
    sectors = 360
    walls = (rng.uniform(0.2, 0.99, sectors) * max_range,
             rng.uniform(2.0, 25.0, sectors),
             rng.choice(WAYMO_GROUND_IDS, sectors),
             rng.choice(WAYMO_STRUCTURE_IDS, sectors))
    rows, cols = np.meshgrid(np.arange(top["rows"]), np.arange(top["cols"]),
                             indexing="ij")
    az = np.pi - 2 * np.pi * (cols + rng.uniform(0, 1, cols.shape)) \
        / top["cols"]
    el = np.deg2rad(top["elevation"][rows] + rng.normal(0, 0.02, rows.shape))
    origin = (0.0, 0.0, top["height"])
    d, hit, lab = _waymo_hits(rng, origin, az, el, walls, top["max_range"])

    def cloud(d, az, el, origin):
        return np.stack([origin[0] + d * np.cos(el) * np.cos(az),
                         origin[1] + d * np.cos(el) * np.sin(az),
                         origin[2] + d * np.sin(el)], -1)

    # a second return behind a share of the hits (foliage, edges)
    second = hit & (rng.random(hit.shape) < second_return)
    d2 = d + rng.uniform(0.3, 3.0, d.shape)
    second &= d2 < top["max_range"]
    parts = []
    for m, dd in ((hit, d), (second, d2)):
        parts.append(dict(xyz=cloud(dd[m], az[m], el[m], origin),
                          lab=lab[m], ri=np.stack([cols[m], rows[m]], -1)))
    n_short = short_points // len(WAYMO_SHORT)
    short = []
    for pos, yaw in WAYMO_SHORT.values():
        a = np.deg2rad(yaw) + rng.uniform(-1.4, 1.4, n_short)
        e = np.deg2rad(rng.uniform(-60.0, 20.0, n_short))
        dd, h, _ = _waymo_hits(rng, pos, a, e, walls,
                               min(20.0, max_range))
        short.append(cloud(dd[h], a[h], e[h], pos))
    xyz = np.concatenate([parts[0]["xyz"], parts[1]["xyz"]] + short)
    n = len(xyz)
    feat = np.stack([rng.uniform(0, 1.0, n), rng.uniform(0, 0.5, n)], 1)
    return dict(xyz=xyz.astype(np.float32), feat=feat.astype(np.float32),
                cp=_waymo_points_cp(xyz, cam_hw),
                labels=np.concatenate([parts[0]["lab"], parts[1]["lab"]]
                                      ).astype(np.uint8),
                n1=len(parts[0]["xyz"]), n2=len(parts[1]["xyz"]),
                ri1=parts[0]["ri"].astype(np.int32),
                ri2=parts[1]["ri"].astype(np.int32))


# Waymo label type -> (w, l, h) in metres
WAYMO_DET_SIZES = {"VEHICLE": (2.0, 4.6, 1.7), "PEDESTRIAN": (0.8, 0.8, 1.8),
                   "CYCLIST": (0.7, 1.8, 1.7), "SIGN": (0.6, 0.3, 0.8)}


def _waymo_boxes(rng, n, max_range, fr, cam_hw):
    """n labelled objects of one frame: their returns are appended to the
    frame's arrays ``fr`` in place -> the converter's box annotations
    (an empty dict without objects)."""
    if not n:
        return {}
    names, boxes, counts, pts = [], [], [], []
    for j in range(n):
        name = "SIGN" if j % 7 == 6 else ("VEHICLE", "PEDESTRIAN",
                                          "CYCLIST")[j % 3]
        w, l, h = (v * rng.uniform(0.9, 1.1) for v in WAYMO_DET_SIZES[name])
        r, a = rng.uniform(4.0, 0.7 * max_range), rng.uniform(-np.pi, np.pi)
        box = [r * np.cos(a), r * np.sin(a), h / 2, l, w, h,
               rng.uniform(-np.pi, np.pi)]
        k = int(rng.integers(20, 81))
        pts.append(_points_in_box(rng, box, k))
        names.append(name)
        boxes.append(box)
        counts.append(k)
    xyz = np.concatenate(pts)
    feat = np.stack([rng.uniform(0, 1.0, len(xyz)),
                     rng.uniform(0, 0.5, len(xyz))], 1).astype(np.float32)
    fr["xyz"] = np.concatenate([fr["xyz"], xyz])
    fr["feat"] = np.concatenate([fr["feat"], feat])
    fr["cp"] = np.concatenate([fr["cp"], _waymo_points_cp(xyz, cam_hw)])
    return {"gt_boxes": np.asarray(boxes, np.float32),
            "gt_names": np.asarray(names, dtype=object),
            "gt_num_points": np.asarray(counts, np.int32)}


def _waymo_pose(i):
    """The vehicle pose (4x4, vehicle -> global) of a seeded tree's frame
    ``i``: heading 0.5 rad, 1 m further along it each frame (so the
    previous frame lies 1 m behind along x, as its sweep transform
    says)."""
    c, s = np.cos(0.5), np.sin(0.5)
    pose = np.eye(4)
    pose[:2, :2] = [[c, -s], [s, c]]
    pose[:3, 3] = [1200.0 + i * c, -340.0 + i * s, 12.0]
    return pose


def write_semanticwaymo_tree(root, splits=("training", "validation"),
                             frames=2, seed=0, cams=tuple(WAYMO_CAMS),
                             cam_hw=None, second_return=0.08,
                             short_points=6000, quality=95, nsweeps=1,
                             top_cols=2650, max_range=75.0, boxes=0):
    """Write a seeded SemanticWaymo tree under ``root`` in the converter's
    layout (datasets/waymo/dataset.py): for each split in ``splits``,
    ``frames`` frame pkls (an int, or a count per split) in
    ``SPLIT_frames/`` of one driving context, 0.1 s apart, each with a
    JPEG (``encode_jpeg_bgr`` at ``quality``) in ``SPLIT_images/`` for
    each camera id in ``cams`` (a camera shows the same seeded image in
    every frame of a split: the encoding takes most of a frame's writing
    time), and the info pkl
    ``infos_SPLIT_{nsweeps:02d}sweeps_segdet.pkl`` (each frame's
    previous frame is its sweep). A frame is a TOP lidar of 64 rows x
    ``top_cols`` columns (Waymo's 2650) within ``max_range`` m (75),
    whose beams end on the ground or the wall of their azimuth sector,
    with a second return behind a ``second_return`` share of the hits,
    then about ``short_points`` returns of the four short-range lidars
    within 20 m (or ``max_range``). The labels (23 classes) cover the
    TOP lidar's returns only (``num_seg_points`` below the point count);
    ``points_cp`` holds each point's [cam_id, w, h] in the first camera
    that sees it, in that camera's own pixels. ``cam_hw`` maps a camera
    id to its image size (W, H), the published sizes by default (three
    at 1920x1280, the two side cameras at 1920x886). ``boxes`` labelled
    objects a frame (VEHICLE, PEDESTRIAN, CYCLIST and now and then a SIGN,
    standing on the ground within 0.7 ``max_range``; drawn from a
    generator of their own, so a tree without them is the same) add
    20-80 returns inside each box after the short-range lidars' and the
    converter's ``gt_boxes`` [N, 7] (x, y, z, length, width, height,
    heading), ``gt_names`` and ``gt_num_points`` to the frame's
    annotations. Each frame pkl carries the converter's ``timestamp`` and
    ``veh_to_global``: the vehicle drives 1 m along its heading (0.5 rad
    in the global frame) each frame. -> {split: info path}."""
    rng = np.random.default_rng(seed)
    brng = np.random.default_rng([seed, 2])  # boxes only
    cam_hw = dict({c: v[2] for c, v in WAYMO_CAMS.items()}, **(cam_hw or {}))
    out = {}
    for split in splits:
        frame_dir = os.path.join(root, f"{split}_frames")
        image_dir = os.path.join(root, f"{split}_images")
        os.makedirs(frame_dir, exist_ok=True)
        os.makedirs(image_dir, exist_ok=True)
        context = f"ctx{int(rng.integers(10**8)):08d}"
        infos, jpegs = [], {}
        for i in range(frames[split] if isinstance(frames, dict)
                       else frames):
            stamp = 1_500_000_000_000_000 + i * 100_000
            token = f"{context}_{stamp}"
            fr = _waymo_frame(rng, second_return, short_points, cam_hw,
                              top_cols, max_range)
            cam_paths = {}
            for c in cams:
                if c not in jpegs:  # a camera's image: one a split
                    W, H = cam_hw[c]
                    jpegs[c] = encode_jpeg_bgr(_kitti_image(rng, H, W),
                                               quality)
                cam_paths[c] = os.path.join(image_dir, f"{token}_cam{c}.jpg")
                with open(cam_paths[c], "wb") as f:
                    f.write(jpegs[c])
            n_top = fr["n1"] + fr["n2"]
            det = _waymo_boxes(brng, boxes, max_range, fr, cam_hw)
            obj = {
                "token": token, "timestamp": stamp / 1e6,
                "veh_to_global": _waymo_pose(i),
                "lidars": {
                    "points_xyz": fr["xyz"], "points_feature": fr["feat"],
                    "points_cp": fr["cp"],
                    "num_points_of_top_lidar": {"ri_return1": fr["n1"],
                                                "ri_return2": fr["n2"]},
                    "top_slices": {"ri1": [0, fr["n1"]],
                                   "ri2": [fr["n1"], fr["n2"]]},
                    "top_ri_indexing": {"ri1": fr["ri1"], "ri2": fr["ri2"]},
                },
                "annotations": {"point_sem_labels": fr["labels"],
                                "num_seg_points": n_top, **det},
                "cam_paths": cam_paths,
            }
            path = os.path.join(frame_dir, f"{token}.pkl")
            with open(path, "wb") as f:
                pickle.dump(obj, f)
            sweeps = []
            if infos:  # the previous frame, 1 m behind along x
                T = np.eye(4, dtype=np.float32)
                T[0, 3] = -1.0
                sweeps.append({"path": infos[-1]["path"], "sweep_to_ref": T,
                               "time_lag": 0.1})
            infos.append({"token": token, "path": path, "context": context,
                          "timestamp": stamp / 1e6, "sweeps": sweeps,
                          "cam_paths": cam_paths})
        out[split] = os.path.join(
            root, f"infos_{split}_{nsweeps:02d}sweeps_segdet.pkl")
        with open(out[split], "wb") as f:
            pickle.dump(infos, f)
    return out


def write_eval_config(path, config, data_root, work_dir=None):
    """Write to ``path`` a copy of the config file ``config`` whose data
    splits read the tree at ``data_root`` (as ``write_semantickitti_tree``
    or ``write_semnusc_tree`` writes it; a split's ``info_path`` keeps its
    file name under ``data_root``), with the image backbone's (if any)
    ``frozen_stages=3`` (as every published MSeg3D config sets it) and,
    if given, ``work_dir``. Returns ``path``."""
    with open(config) as f:
        text = f.read()
    text += (f"\nfor _split in ('train', 'val', 'test'):\n"
             f"    data[_split]['root_path'] = {data_root!r}\n"
             "    if 'info_path' in data[_split]:\n"
             f"        data[_split]['info_path'] = {data_root!r} + '/' + "
             "data[_split]['info_path'].rsplit('/', 1)[-1]\n"
             "if model.get('img_backbone'):\n"
             "    model['img_backbone']['frozen_stages'] = 3\n")
    if work_dir is not None:
        text += f"work_dir = {work_dir!r}\n"
    with open(path, "w") as f:
        f.write(text)
    return path


# a published SegNet config cut to a mini model (its pipelines, dataset,
# optimizer and schedule stay the published ones): a 25.6 m grid at 0.4 m,
# capacity 2048, UNetSCN3D r=1, TransVFE of one 16-wide layer, 16-wide
# head layers, B=2
_MINI_SEGNET = """
point_cloud_range = [-12.8, -12.8, -3.0, 12.8, 12.8, 3.0]
voxel_size = [0.4, 0.4, 0.3]
voxel_generator.update(range=point_cloud_range, voxel_size=voxel_size,
                       max_voxel_num=[2000, 2000])
capacity = dict(max_voxels=2048, max_points=2048)
train_preprocessor["npoints"] = 2000
model["backbone"].update(point_cloud_range=point_cloud_range,
                         voxel_size=voxel_size)
model["backbone"]["model_cfg"]["SCALING_RATIO"] = 1
model["point_head"]["model_cfg"].update(CONV_IN_DIM=16, CONV_CLS_FC=[16],
                                        CONV_ALIGN_DIM=16, OUT_CLS_FC=[16])
if model["reader"]["type"] == "TransformerVoxelFeatureExtractor":
    model["reader"].update(num_embed=16, num_layers=1)
for _split in ("train", "val", "test"):
    data[_split]["root_path"] = {root!r}
    if "info_path" in data[_split]:
        data[_split]["info_path"] = ({root!r} + "/"
                                     + data[_split]["info_path"].rsplit("/")[-1])
    if "sequences" in data[_split]:
        data[_split]["sequences"] = ["08"] if _split != "train" else ["00"]
data.update(samples_per_gpu=2, workers_per_gpu=1)
log_config = dict(interval=1)
work_dir = {work!r}
"""


# the cameras of a nuScenes split (the lidar baselines keep the MSeg3D
# config's camera settings) cut to those of the tree
_MINI_CAMS = """
for _split in ("train", "val", "test"):
    if data[_split].get("cam_chan"):
        _names = [str(i + 1) for i in range({n})]
        data[_split].update(
            cam_chan={chans!r}, cam_names=_names,
            cam_attributes={{c: data[_split]["cam_attributes"][c]
                            for c in _names}})
"""


def write_mini_segnet_config(path, config, data_root, work_dir="unused",
                             cam_chans=None):
    """Write to ``path`` the published SegNet config file ``config`` cut to
    a mini model (``_MINI_SEGNET``) whose splits read the tree at
    ``data_root``: SemanticKITTI's sequences directory (train "00", val and
    test "08", as ``write_semantickitti_tree`` writes them) or a nuScenes
    root with its infos, whose camera channels ``cam_chans`` (if given)
    replace a split's. Returns ``path``."""
    with open(config) as f:
        text = f.read() + _MINI_SEGNET.format(root=data_root, work=work_dir)
    if cam_chans is not None:
        text += _MINI_CAMS.format(n=len(cam_chans), chans=list(cam_chans))
    with open(path, "w") as f:
        f.write(text)
    return path


# a published SegPolarNet config (Cylinder3D, its _v2p variant, PolarNet)
# cut to a mini model (its pipelines, dataset, optimizer and schedule stay
# the published ones): a 32x32x8 cylindrical grid within 12.8 m, a 32-wide
# (Cylinder3D) or 64-wide (PolarNet) PP model, Cylinder3D at init_size 4
# with 1,200 voxels, 16-wide batch-loss head layers, 2,048 points, B=2
_MINI_POLAR = """
cylindrical_range = [0, -np.pi, -5.0, 12.8, np.pi, 3.0]
cylindrical_grid_size = [32, 32, 8]
model["reader"].update(grid_size=cylindrical_grid_size,
                       point_cloud_range=cylindrical_range, fea_compre=8)
if model["reader"]["type"].startswith("Cylinder3D"):
    model["reader"].update(num_output_features=32, max_voxels=1200)
    model["backbone"].update(output_shape=cylindrical_grid_size,
                             num_input_features=8, n_height=8, init_size=4)
else:
    model["reader"].update(num_output_features=64)
    model["backbone"].update(n_height=8)
if model["point_head"]["type"] == "PointSegBatchlossHead":
    model["point_head"]["model_cfg"].update(CONV_CLS_FC=[16],
                                            CONV_ALIGN_DIM=16,
                                            OUT_CLS_FC=[16])
capacity = dict(max_points=2048)
train_preprocessor["npoints"] = 2000
for _split in ("train", "val", "test"):
    data[_split]["root_path"] = {root!r}
    data[_split]["info_path"] = ({root!r} + "/"
                                 + data[_split]["info_path"].rsplit("/")[-1])
data.update(samples_per_gpu=2, workers_per_gpu=1)
log_config = dict(interval=1)
work_dir = {work!r}
"""


def write_mini_polar_config(path, config, data_root, work_dir="unused"):
    """Write to ``path`` the published SegPolarNet config file ``config``
    (Cylinder3D, Cylinder3D _v2p or PolarNet on nuScenes) cut to a mini
    model (``_MINI_POLAR``) whose splits read the nuScenes tree with its
    infos at ``data_root``. Returns ``path``."""
    with open(config) as f:
        text = f.read() + _MINI_POLAR.format(root=data_root, work=work_dir)
    with open(path, "w") as f:
        f.write(text)
    return path


# a published SemanticWaymo config (MSeg3D or its lidar baseline) cut to a
# mini model (its pipelines, dataset, optimizer and schedule stay the
# published ones): a 25.6 m grid at 0.4 m, capacity 2048 voxels / 4096
# points, the five cameras resized to 96x64, a tiny HRNet (frozen_stages=3)
# and head, UNetSCN3D r=1, B=2
_MINI_WAYMO = """
point_cloud_range = [-12.8, -12.8, -2.0, 12.8, 12.8, 4.0]
voxel_size = [0.4, 0.4, 0.3]
voxel_generator.update(range=point_cloud_range, voxel_size=voxel_size,
                       max_voxel_num=[2000, 2000])
capacity = dict(max_voxels=2048, max_points=4096)
train_preprocessor["npoints"] = 4000
model["backbone"].update(point_cloud_range=point_cloud_range,
                         voxel_size=voxel_size)
model["backbone"]["model_cfg"]["SCALING_RATIO"] = 1
if model.get("img_backbone"):
    model["img_backbone"].update(pretrained=None, extra=dict(
        stage1=dict(num_modules=1, num_branches=1, block="BOTTLENECK",
                    num_blocks=(1,), num_channels=(8,)),
        stage2=dict(num_modules=1, num_branches=2, block="BASIC",
                    num_blocks=(1, 1), num_channels=(4, 8)),
        stage3=dict(num_modules=1, num_branches=3, block="BASIC",
                    num_blocks=(1, 1, 1), num_channels=(4, 8, 16)),
        stage4=dict(num_modules=1, num_branches=4, block="BASIC",
                    num_blocks=(1, 1, 1, 1), num_channels=(4, 8, 16, 32))))
    model["img_head"].update(in_channels=(4, 8, 16, 32), num_convs=1,
                             channels=12)
    model["point_head"]["model_cfg"].update(
        VOXEL_IN_DIM=16, VOXEL_CLS_FC=[16], VOXEL_ALIGN_DIM=16,
        IMAGE_IN_DIM=12, IMAGE_ALIGN_DIM=16, GEO_FUSED_DIM=16,
        OUT_CLS_FC=[16], MIMIC_FC=[16],
        SFPhase_CFG=dict(embeddings_proj_kernel_size=1, d_model=16,
                         n_head=4, n_layer=2, n_ffn=32, drop_ratio=0,
                         activation="relu", pre_norm=False))
else:
    model["point_head"]["model_cfg"].update(CONV_IN_DIM=16, CONV_CLS_FC=[16],
                                            CONV_ALIGN_DIM=16,
                                            OUT_CLS_FC=[16])
for _split in ("train", "val", "test"):
    data[_split].update(
        root_path={root!r}, img_resized_shape=(96, 64),
        info_path={root!r} + "/" + data[_split]["info_path"].rsplit("/")[-1])
data.update(samples_per_gpu=2, workers_per_gpu=1)
log_config = dict(interval=1)
work_dir = {work!r}
"""

# the image sizes of a mini SemanticWaymo tree (W, H): the published
# 3:2 and 2.17:1 aspect ratios at a tenth of the width
MINI_WAYMO_CAMS = {"1": (192, 128), "2": (192, 128), "3": (192, 128),
                   "4": (192, 89), "5": (192, 89)}


def write_mini_waymo_config(path, config, data_root, work_dir="unused"):
    """Write to ``path`` the published SemanticWaymo config file ``config``
    cut to a mini model (``_MINI_WAYMO``) whose splits read the tree at
    ``data_root`` (as ``write_semanticwaymo_tree`` writes it, small:
    ``top_cols=24, max_range=12.0, short_points=400,
    cam_hw=MINI_WAYMO_CAMS``). Returns ``path``."""
    with open(config) as f:
        text = f.read() + _MINI_WAYMO.format(root=data_root, work=work_dir)
    with open(path, "w") as f:
        f.write(text)
    return path



# a published detection config (CenterPoint VoxelNet or PointPillars on
# nuScenes or Waymo) cut to a mini model (its pipelines, augmentations,
# gt sampling, dataset, optimizer and schedule stay the published ones):
# a 25.6 m grid (VoxelNet: 0.2 m and 17 slabs, so the BEV map is 16x16
# of 2 * 128 channels, room for the decode's top 100 of a one-class task;
# PointPillars: 0.4 m, a 64x64 canvas), capacity 2048 voxels,
# one conv per RPN block at 16 / 32 channels, a 16-wide shared head conv,
# B=2; a two-stage config's first stage so, its extractors on that grid
# and its RoI head's layers 16 wide
_MINI_DET = """
point_cloud_range = [-12.8, -12.8, point_cloud_range[2], 12.8, 12.8,
                     point_cloud_range[5]]
_m = (model["first_stage_cfg"] if model["type"] == "TwoStageDetector"
      else model)
if _m["type"] == "PointPillars":
    voxel_size = [0.4, 0.4, point_cloud_range[5] - point_cloud_range[2]]
    _m["reader"].update(voxel_size=tuple(voxel_size),
                           pc_range=tuple(point_cloud_range),
                           num_filters=(16, 16))
    _m["backbone"].update(num_input_features=16)
    _m["neck"].update(layer_nums=(1, 1, 1), ds_num_filters=(16, 32, 32),
                         us_num_filters=(16, 16, 16), num_input_features=16)
else:
    voxel_size = [0.2, 0.2, (point_cloud_range[5] - point_cloud_range[2])
                  / 16]
    _m["neck"].update(layer_nums=(1, 1), ds_num_filters=(16, 32),
                      us_num_filters=(16, 16))
_m["bbox_head"].update(share_conv_channel=16)
if model["type"] == "TwoStageDetector":
    model["second_stage_modules"] = tuple(
        dict(m, pc_start=point_cloud_range[:2], voxel_size=voxel_size[:2])
        for m in model["second_stage_modules"])
    model["roi_head"]["input_channels"] = 32 * model["num_point"]
    model["roi_head"]["model_cfg"].update(SHARED_FC=(16, 16),
                                          CLS_FC=(16, 16), REG_FC=(16, 16))
voxel_generator.update(range=point_cloud_range, voxel_size=voxel_size,
                       max_voxel_num=[2000, 2000])
capacity = dict(max_voxels=2048, max_points={max_points})
assigner.update(pc_range=point_cloud_range, voxel_size=voxel_size)
test_cfg.update(pc_range=point_cloud_range[:2], voxel_size=voxel_size[:2])
if "db_sampler" in globals():
    db_sampler["db_info_path"] = {root!r} + "/dbinfos_train.pkl"
for _split in ("train", "val", "test"):
    data[_split]["root_path"] = {root!r}
    data[_split]["info_path"] = ({root!r} + "/"
                                 + data[_split]["info_path"].rsplit("/")[-1])
data.update(samples_per_gpu=2, workers_per_gpu=1)
log_config = dict(interval=1)
work_dir = {work!r}
"""


def write_mini_det_config(path, config, data_root, work_dir="unused",
                          max_points=16384):
    """Write to ``path`` the published detection config file ``config``
    cut to a mini model (``_MINI_DET``) whose splits read the tree at
    ``data_root``: a nuScenes tree with boxes, sweeps and its infos
    (``write_semnusc_tree(..., boxes=N, sweeps=9)``,
    ``create_nuscenes_seg_infos(root, nsweeps=10, cam_chans=())``), or a
    Waymo tree with boxes (``write_semanticwaymo_tree(root, splits=("train",
    "val"), boxes=N, ...)``) and, for a config with a ``db_sampler``, its
    gt database (``tools.create_data waymo_gt_database``). Returns
    ``path``."""
    with open(config) as f:
        text = f.read() + _MINI_DET.format(root=data_root, work=work_dir,
                                           max_points=max_points)
    with open(path, "w") as f:
        f.write(text)
    return path
