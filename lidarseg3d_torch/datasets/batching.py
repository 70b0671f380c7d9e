"""Padded fixed-capacity batches from per-frame host data (own copy of
``pad_axis0``, ``collate_segnet`` and ``pad_batch_rows`` of
lidarseg3d_tpu/datasets/batching.py): the segmentation keys and the
detection extras (``det_targets`` stacked per task, ``gt_boxes_and_cls``)."""

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


def pad_axis0(arr, size, fill=0):
    """Pad/truncate arr along axis 0 to ``size``."""
    n = min(arr.shape[0], size)
    shape = (size,) + arr.shape[1:]
    out = (np.zeros(shape, dtype=arr.dtype) if fill == 0
           else np.full(shape, fill, dtype=arr.dtype))
    out[:n] = arr[:n]
    return out


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
    """frames: per-frame dicts with points [n,D] and, from a host
    voxelization, voxels [v,P,D], coordinates [v,3] zyx and
    num_points_per_voxel [v]; optionally images / points_cuv /
    images_sem_labels / voxel_sem_labels / point_sem_labels. Returns
    stacked numpy arrays (B leading; images_sem_labels [B * ncam, H, W]),
    padded to the capacities. Frames without voxels (a model that
    voxelizes on the device) give a batch of points only: no voxel keys
    and no voxel_valid."""
    _check_overflow(frames, max_voxels, max_points, on_overflow)
    batch = {}
    if "voxels" in frames[0]:
        batch["voxels"] = _pad_stack([fr["voxels"] for fr in frames],
                                     max_voxels, np.float32)
        batch["coordinates"] = _pad_stack(
            [np.asarray(fr["coordinates"], np.int32) for fr in frames],
            max_voxels, np.int32, fill=-1)
        batch["num_points"] = _pad_stack(
            [np.asarray(fr["num_points_per_voxel"], np.int32)
             for fr in frames], max_voxels, np.int32)
        batch["num_voxels"] = np.asarray(
            [min(fr["voxels"].shape[0], max_voxels) for fr in frames],
            np.int32)
    batch["points"] = _pad_stack(
        [np.asarray(fr["points"], np.float32) for fr in frames],
        max_points, np.float32)
    batch["num_points_total"] = np.asarray(
        [min(fr["points"].shape[0], max_points) for fr in frames], np.int32)
    if "images" in frames[0]:
        batch["images"] = (frames[0]["images"][None] if len(frames) == 1
                           else np.stack([fr["images"] for fr in frames]))
        batch["points_cuv"] = _pad_stack(
            [np.asarray(fr["points_cuv"], np.float32) for fr in frames],
            max_points, np.float32)
        if "images_sem_labels" in frames[0]:
            batch["images_sem_labels"] = np.concatenate(
                [np.asarray(fr["images_sem_labels"], np.int32)
                 for fr in frames], axis=0)  # [B * ncam, H, W]
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
    if "num_voxels" in batch:
        batch["voxel_valid"] = (
            np.arange(max_voxels)[None, :] < batch["num_voxels"][:, None])
    batch["metadata"] = [fr.get("metadata") for fr in frames]
    # detection: the center targets stacked per task, the padded gt boxes
    if "det_targets" in frames[0]:
        batch["det_targets"] = [
            {k: np.stack([fr["det_targets"][t][k] for fr in frames])
             for k in frames[0]["det_targets"][t]}
            for t in range(len(frames[0]["det_targets"]))]
    if "gt_boxes_and_cls" in frames[0]:
        batch["gt_boxes_and_cls"] = np.stack(
            [fr["gt_boxes_and_cls"] for fr in frames])
    return batch


def pad_batch_rows(batch, multiple):
    """Pad the batch dim to a multiple of ``multiple`` with empty rows
    (no voxels or points: all masks False). metadata is not padded: consumers
    iterate over metadata to skip the empty rows."""
    B = batch["points"].shape[0]
    pad = (-B) % multiple
    if pad == 0:
        return batch
    ncam = batch["images"].shape[1] if "images" in batch else 1
    out = {}
    for k, v in batch.items():
        if k == "metadata":
            out[k] = v
        else:
            p = pad * ncam if k == "images_sem_labels" else pad
            out[k] = np.concatenate(
                [v, np.zeros((p,) + v.shape[1:], dtype=v.dtype)], axis=0)
    return out
