"""Padded fixed-capacity batches from per-frame host data (own copy of
``collate_segnet`` in lidarseg3d_tpu/datasets/batching.py, segmentation
keys only)."""

import logging

import numpy as np

logger = logging.getLogger(__name__)


def _check_overflow(frames, max_voxels, max_points, on_overflow):
    """Loudly handle frames exceeding the padded capacity ("error",
    "warn" or "silent")."""
    if on_overflow == "silent":
        return
    dropped_v = sum(max(0, fr["voxels"].shape[0] - max_voxels)
                    for fr in frames if "voxels" in fr)
    dropped_p = sum(max(0, np.asarray(fr["points"]).shape[0] - max_points)
                    for fr in frames)
    if not (dropped_v or dropped_p):
        return
    msg = (f"capacity overflow at collate: dropped {dropped_v} voxel rows "
           f"(max_voxels={max_voxels}) and {dropped_p} point rows "
           f"(max_points={max_points}) across {len(frames)} frames")
    if on_overflow == "error":
        raise ValueError(msg)
    logger.warning(msg)


def _pad_stack(arrs, size, dtype, fill=0):
    """Pad each [n, ...] array to ``size`` rows into one [B, size, ...]."""
    shape = (len(arrs), size) + arrs[0].shape[1:]
    out = (np.zeros(shape, dtype) if fill == 0
           else np.full(shape, fill, dtype))
    for b, a in enumerate(arrs):
        n = min(a.shape[0], size)
        out[b, :n] = a[:n]
    return out


def collate_segnet(frames, max_voxels, max_points, ignore_label=0,
                   on_overflow="warn"):
    """frames: per-frame dicts with voxels [v,P,D], coordinates [v,3] zyx,
    num_points_per_voxel [v], points [n,D], optionally images /
    points_cuv / voxel_sem_labels / point_sem_labels. Returns stacked numpy
    arrays (B leading), padded to the capacities."""
    _check_overflow(frames, max_voxels, max_points, on_overflow)
    batch = {}
    batch["voxels"] = _pad_stack([fr["voxels"] for fr in frames],
                                 max_voxels, np.float32)
    batch["coordinates"] = _pad_stack(
        [np.asarray(fr["coordinates"], np.int32) for fr in frames],
        max_voxels, np.int32, fill=-1)
    batch["num_points"] = _pad_stack(
        [np.asarray(fr["num_points_per_voxel"], np.int32) for fr in frames],
        max_voxels, np.int32)
    batch["num_voxels"] = np.asarray(
        [min(fr["voxels"].shape[0], max_voxels) for fr in frames], np.int32)
    batch["points"] = _pad_stack(
        [np.asarray(fr["points"], np.float32) for fr in frames],
        max_points, np.float32)
    batch["num_points_total"] = np.asarray(
        [min(fr["points"].shape[0], max_points) for fr in frames], np.int32)
    if "images" in frames[0]:
        batch["images"] = np.stack([fr["images"] for fr in frames])
        batch["points_cuv"] = _pad_stack(
            [np.asarray(fr["points_cuv"], np.float32) for fr in frames],
            max_points, np.float32)
    if "voxel_sem_labels" in frames[0]:
        batch["voxel_sem_labels"] = _pad_stack(
            [np.asarray(fr["voxel_sem_labels"], np.int32) for fr in frames],
            max_voxels, np.int32, fill=ignore_label)
    if "point_sem_labels" in frames[0]:
        batch["point_sem_labels"] = _pad_stack(
            [np.asarray(fr["point_sem_labels"], np.int32) for fr in frames],
            max_points, np.int32, fill=ignore_label)
    batch["point_valid"] = (
        np.arange(max_points)[None, :] < batch["num_points_total"][:, None])
    batch["voxel_valid"] = (
        np.arange(max_voxels)[None, :] < batch["num_voxels"][:, None])
    batch["metadata"] = [fr.get("metadata") for fr in frames]
    return batch
