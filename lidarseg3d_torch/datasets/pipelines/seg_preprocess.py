"""Segmentation preprocessing stages of the evaluation pipeline (own copy of
the val paths of lidarseg3d_tpu/datasets/pipelines/seg_preprocess.py):
SegPreprocess, SegVoxelization on core/voxelize.py, SegImagePreprocess
(resize, normalize, points_cuv) and Reformat. The training branches
(point and image augmentations, SegAssignLabel) and the TTA variants
(SegCompoundAug) are not ported yet and raise.
"""

import numpy as np

from ...core.voxelize import VoxelGenerator
from ..registry import PIPELINES
from . import img_transforms as T


def _train_not_ported(stage):
    return NotImplementedError(
        f"{stage}: the training branch (augmentations) is not ported to "
        "lidarseg3d_torch yet")


@PIPELINES.register_module
class SegPreprocess:
    def __init__(self, cfg=None, **kwargs):
        self.mode = cfg["mode"]
        self.shuffle_points = cfg["shuffle_points"]
        self.npoints = cfg.get("npoints", -1)
        if self.mode == "train":
            raise _train_not_ported("SegPreprocess")

    def __call__(self, sample, info):
        sample["mode"] = self.mode
        rng = sample.get("rng") or np.random.default_rng()
        points = sample["points"]
        if self.shuffle_points:
            idx = rng.permutation(points.shape[0])
            points = points[idx]
        else:
            idx = np.arange(points.shape[0])
        sample["all_points"] = points
        if self.npoints > 0 and points.shape[0] > self.npoints:
            points = points[: self.npoints]
            idx = idx[: self.npoints]
        sample["points"] = points
        sample["points_shuffle_idx"] = idx
        return sample, info


@PIPELINES.register_module
class SegVoxelization:
    def __init__(self, cfg=None, **kwargs):
        self.range = cfg["range"]
        self.voxel_size = cfg["voxel_size"]
        self.max_points_in_voxel = cfg["max_points_in_voxel"]
        mv = cfg["max_voxel_num"]
        self.max_voxel_num = [mv, mv] if isinstance(mv, int) else mv
        if cfg.get("tta_flag", False):
            raise NotImplementedError("SegVoxelization: TTA variants are not "
                                      "ported to lidarseg3d_torch yet")
        if not cfg.get("sort_by_key", True):
            raise NotImplementedError("SegVoxelization: the port voxelizes "
                                      "in key order only (sort_by_key)")
        self.voxel_generator = VoxelGenerator(
            voxel_size=self.voxel_size, point_cloud_range=self.range,
            max_num_points=self.max_points_in_voxel,
            max_voxels=self.max_voxel_num[0])

    def __call__(self, sample, info):
        if sample["mode"] == "train":
            raise _train_not_ported("SegVoxelization")
        voxels, coordinates, num_points = self.voxel_generator.generate(
            sample["points"], max_voxels=self.max_voxel_num[1])
        sample["voxels"] = dict(
            voxels=voxels, coordinates=coordinates, num_points=num_points,
            num_voxels=np.array([voxels.shape[0]], dtype=np.int64),
            shape=self.voxel_generator.grid_size,
            range=np.asarray(self.range, np.float32),
            size=np.asarray(self.voxel_size, np.float32))
        return sample, info


@PIPELINES.register_module
class Reformat:
    """Assemble the per-frame dict the collate consumes."""

    def __init__(self, **kwargs):
        pass

    def __call__(self, sample, info):
        if sample.get("num_tta_transforms", 0) > 0:
            raise NotImplementedError("Reformat: TTA variants are not "
                                      "ported to lidarseg3d_torch yet")
        frame = {
            "points": sample["points"].astype(np.float32),
            "metadata": sample.get("metadata", {"token": info.get("token")}),
        }
        if "voxels" in sample:
            vox = sample["voxels"]
            frame["voxels"] = vox["voxels"].astype(np.float32)
            frame["coordinates"] = vox["coordinates"]
            frame["num_points_per_voxel"] = vox["num_points"]
        if "points_cuv" in sample:
            frame["points_cuv"] = sample["points_cuv"].astype(np.float32)
            frame["images"] = sample["images"].astype(np.float32)
        return frame, info


@PIPELINES.register_module
class SegImagePreprocess:
    """Camera images of the evaluation pipeline: each camera resized to the
    common shape (its points' pixel coordinates with it), normalized per
    camera into one preallocated block, and the per-point
    points_cuv = [valid, norm_cam, norm_v, norm_u] in [-1, 1]."""

    def __init__(self, cfg=None, **kwargs):
        cfg = cfg or {}
        self.shuffle_points = cfg.get("shuffle_points", False)
        self.no_augmentation = cfg.get("no_augmentation", False)

    def __call__(self, sample, info):
        if sample["mode"] == "train" and not self.no_augmentation:
            raise _train_not_ported("SegImagePreprocess")
        cam_names = info["cam"]["names"]
        cam_attributes = info["cam"]["attributes"]
        resized_shape = info["cam"]["resized_shape"]  # (W, H)
        points_cp = sample["points_cp"].copy()
        out_images = []
        for cam_id, img in zip(cam_names, sample["images"]):
            sel = points_cp[:, 0] == int(cam_id)
            img, cp, _ = T.resize_image_points_label(
                img, points_cp[sel], None, resized_shape)
            points_cp[sel] = cp
            out_images.append(img)
        H, W = out_images[0].shape[:2]
        images_out = np.empty((len(out_images), H, W, 3), np.float32)
        for ci, (cam_id, img) in enumerate(zip(cam_names, out_images)):
            attr = cam_attributes[cam_id]
            T.normalize_image_into(img, attr["mean"], attr["std"],
                                   images_out[ci])

        idx = sample.get("points_shuffle_idx")
        if idx is not None:
            points_cp = points_cp[idx]
        n = points_cp.shape[0]
        cuv = np.full((n, 4), -100.0, np.float32)
        cuv[:, 0] = (points_cp[:, 0] > 0).astype(np.float32)
        if len(cam_names) > 1:
            cuv[:, 1] = (points_cp[:, 0] - 1) / (len(cam_names) - 1) * 2 - 1
        else:
            cuv[:, 1] = 0.0
        cuv[:, 2] = points_cp[:, 2] / (H - 1) * 2 - 1  # v (height)
        cuv[:, 3] = points_cp[:, 1] / (W - 1) * 2 - 1  # u (width)

        sample["points_cp"] = points_cp
        sample["points_cuv"] = cuv
        sample["images"] = images_out  # [ncam, H, W, 3] fp32
        return sample, info
