"""Model configs and synthetic inputs of the bench shapes (own copies of
``_mseg3d_model_cfg``, ``_synthetic_batch`` and ``_synthetic_mseg3d_batch``
from the repository's ``__graft_entry__.py``), plus the host->device
conversion of a collated batch.

The SemanticKITTI bench shape: point cloud range PCR at voxel size VSZ
gives the input spatial shape (Z, Y, X) = (21, 256, 256); one camera at
384x1280; V=131072 voxels and N=122880 points.
"""

import numpy as np
import torch

from .core.voxelize import VoxelGenerator
from .datasets.batching import collate_segnet

PCR = (-25.6, -25.6, -4.0, 25.6, 25.6, 2.0)
VSZ = (0.2, 0.2, 0.3)


def grid_shape(pcr=None, vsz=None):
    """(Z, Y, X) input spatial shape: Z gets one extra slab, as in the
    JAX package's bench."""
    pcr = pcr or PCR
    vsz = vsz or VSZ
    grid = np.round((np.asarray(pcr[3:]) - np.asarray(pcr[:3]))
                    / np.asarray(vsz)).astype(int)
    return (int(grid[2]) + 1, int(grid[1]), int(grid[0]))


def synthetic_batch(B, V, N, P=5, seed=0, pcr=None, vsz=None):
    """Plausible LiDAR scan: ground plane + clutter, voxelized on host."""
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
        voxels, coords, npts = vg.generate(pts)
        frames.append({"voxels": voxels[:, :, :4], "coordinates": coords,
                       "num_points_per_voxel": npts, "points": pts})
    return collate_segnet(frames, max_voxels=V, max_points=N)


def mseg3d_model_cfg(num_class=20, ratio=2, small_hrnet=False, pcr=None,
                     vsz=None):
    """MSeg3D flagship: ImprovedMeanVFE + UNetSCN3D(r) + HRNet-w18 + FCN
    head + fusion head. ``small_hrnet`` keeps the w18 widths with one
    module / one block per stage (for small tests)."""
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
    return dict(
        type="SegMSeg3DNet",
        img_backbone=dict(type="HRNet", extra=extra),
        img_head=dict(
            type="FCNMSeg3DHead", num_classes=num_class, ignore_index=0,
            in_index=(0, 1, 2, 3), in_channels=(18, 36, 72, 144),
            num_convs=2, channels=48, concat_input=False, loss_weight=0.5,
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


def synthetic_mseg3d_batch(B, V, N, img_hw=(384, 1280), ncam=1, seed=0,
                           pcr=None, vsz=None):
    """SegNet batch + synthetic camera images and point->pixel projections."""
    rng = np.random.default_rng(seed)
    batch = synthetic_batch(B, V, N, seed=seed, pcr=pcr, vsz=vsz)
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
    return batch


def example_to_device(batch, device, input_shape):
    """Collated numpy batch -> dict of tensors on ``device`` (metadata
    dropped) with the static ``input_shape`` (Z, Y, X) attached."""
    ex = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
          for k, v in batch.items() if k != "metadata"}
    ex["input_shape"] = tuple(int(s) for s in input_shape)
    return ex
