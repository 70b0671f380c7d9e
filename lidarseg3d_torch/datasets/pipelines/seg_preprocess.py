"""Segmentation preprocessing stages (own copy of
lidarseg3d_tpu/datasets/pipelines/seg_preprocess.py): SegPreprocess (the
train-time point augmentations, the shuffle of points and labels,
``points_with_labels`` and the ``npoints`` cap), SegVoxelization on
core/voxelize.py (with the test-time augmentation's variants),
SegAssignLabel (one label per voxel), SegCompoundAug (the variants'
clouds), SegImagePreprocess (resize, the train-time image augmentations,
normalize, points_cuv) and Reformat (one frame, or the list of a frame's
variants). Every draw comes from the sample's ``rng`` in the JAX
package's order.
"""

import numpy as np

from ...core import augment as aug
from ...core.voxelize import (VoxelGenerator, encode_compact_value_labels,
                              encode_major_value_labels)
from ..registry import PIPELINES
from . import img_transforms as T


@PIPELINES.register_module
class SegPreprocess:
    def __init__(self, cfg=None, **kwargs):
        self.mode = cfg["mode"]
        self.shuffle_points = cfg["shuffle_points"]
        self.npoints = cfg.get("npoints", -1)
        self.no_augmentation = cfg.get("no_augmentation", False)
        if self.mode == "train":
            self.global_rotation_noise = cfg["global_rot_noise"]
            self.global_scaling_noise = cfg["global_scale_noise"]
            self.global_translate_std = cfg.get("global_translate_std", 0)

    def __call__(self, sample, info):
        sample["mode"] = self.mode
        train = self.mode == "train"
        rng = sample.get("rng") or np.random.default_rng()
        points = sample["points"]
        if train:
            sem = sample["annotations"]["point_sem_labels"]
            inst = sample["annotations"]["point_inst_labels"]
            if not self.no_augmentation:
                points = aug.points_random_flip(points, rng=rng)
                points = aug.points_global_rotation(
                    points, rotation=self.global_rotation_noise, rng=rng)
                points = aug.points_global_scaling(
                    points, *self.global_scaling_noise, rng=rng)
                points = aug.points_global_translate(
                    points, self.global_translate_std, rng=rng)
        if self.shuffle_points:
            idx = rng.permutation(points.shape[0])
            points = points[idx]
            if train:
                sem, inst = sem[idx], inst[idx]
        else:
            idx = np.arange(points.shape[0])
        if train:
            # +1 marks the padding slots (0) in the voxel label vote
            sample["points_with_labels"] = np.concatenate(
                [points, sem[:, None].astype(np.float32) + 1.0], axis=-1)
        sample["all_points"] = points
        if self.npoints > 0 and points.shape[0] > self.npoints:
            points = points[: self.npoints]
            idx = idx[: self.npoints]
            if train:
                sample["points_with_labels"] = sample["points_with_labels"][
                    : self.npoints]
                sem, inst = sem[: self.npoints], inst[: self.npoints]
        if train:
            sample["annotations"] = {"point_sem_labels": sem,
                                     "point_inst_labels": inst}
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
        self.voxel_generator = VoxelGenerator(
            voxel_size=self.voxel_size, point_cloud_range=self.range,
            max_num_points=self.max_points_in_voxel,
            max_voxels=self.max_voxel_num[0],
            sort_by_key=cfg.get("sort_by_key", True))

    def __call__(self, sample, info):
        train = sample["mode"] == "train"
        max_voxels = self.max_voxel_num[0 if train else 1]
        voxels, coordinates, num_points = self.voxel_generator.generate(
            sample["points_with_labels"] if train else sample["points"],
            max_voxels=max_voxels)
        sample["voxels"] = dict(
            voxels=voxels, coordinates=coordinates, num_points=num_points,
            num_voxels=np.array([voxels.shape[0]], dtype=np.int64),
            shape=self.voxel_generator.grid_size,
            range=np.asarray(self.range, np.float32),
            size=np.asarray(self.voxel_size, np.float32))
        # the TTA variants SegCompoundAug made (the config's tta_flag only
        # marks a pipeline that has that stage in front)
        for i in range(1, sample.get("num_tta_transforms", 0)):
            v, c, n = self.voxel_generator.generate(
                sample[f"tta_{i}_points"], max_voxels=max_voxels)
            sample[f"tta_{i}_voxels"] = dict(
                voxels=v, coordinates=c, num_points=n,
                num_voxels=np.array([v.shape[0]], dtype=np.int64),
                shape=self.voxel_generator.grid_size)
        return sample, info


@PIPELINES.register_module
class SegAssignLabel:
    """One label per voxel from its points' (+1-shifted) labels, the
    voxels' last feature column, which is dropped here."""

    def __init__(self, cfg=None, **kwargs):
        self.voxel_label_enc = cfg["voxel_label_enc"]
        if self.voxel_label_enc not in ("compact_value", "major_value"):
            raise NotImplementedError(self.voxel_label_enc)

    def __call__(self, sample, info):
        if sample["mode"] != "train":
            return sample, info
        dim_feat = info["dim"]["points"]
        vox = sample["voxels"]["voxels"]
        labels = vox[..., dim_feat].astype(np.int64)
        sample["voxels"]["voxels"] = vox[..., :dim_feat]
        encode = (encode_compact_value_labels
                  if self.voxel_label_enc == "compact_value"
                  else encode_major_value_labels)
        sample["targets"] = {
            "voxel_sem_labels": encode(labels).astype(np.int32),
            "point_sem_labels": sample["annotations"]["point_sem_labels"]}
        return sample, info


@PIPELINES.register_module
class SegCompoundAug:
    """Test-time augmentation: the clouds of variants 1..T-1 of a frame
    (variant 0 is the frame itself), each a copy of its points flipped,
    rotated, scaled and translated with draws from the frame's ``rng``, in
    variant order. The config keys are the JAX package's
    (``num_tta_tranforms``, ``global_rot_noise``, ``global_scale_noise``,
    ``global_translate_std``; the flip probability is 0.5); others are
    ignored, as there (ROADMAP, reference caveat 8)."""

    def __init__(self, cfg=None, **kwargs):
        self.num_tta_transforms = cfg.get(
            "num_tta_tranforms", cfg.get("num_tta_transforms", 4))
        self.rot = cfg.get("global_rot_noise", [-0.78539816, 0.78539816])
        self.scale = cfg.get("global_scale_noise", [0.95, 1.05])
        self.translate = cfg.get("global_translate_std", 0.5)

    def __call__(self, sample, info):
        rng = sample.get("rng") or np.random.default_rng()
        for i in range(1, self.num_tta_transforms):
            p = sample["points"].copy()
            p = aug.points_random_flip(p, rng=rng)
            p = aug.points_global_rotation(p, rotation=self.rot, rng=rng)
            p = aug.points_global_scaling(p, *self.scale, rng=rng)
            p = aug.points_global_translate(p, self.translate, rng=rng)
            sample[f"tta_{i}_points"] = p
        sample["num_tta_transforms"] = self.num_tta_transforms
        return sample, info


@PIPELINES.register_module
class Reformat:
    """Assemble the per-frame dict the collate consumes; with TTA variants
    the list of the frame and its variants, which the loader makes
    consecutive batch rows. A variant carries the frame's metadata and
    camera keys: the cameras see the original cloud (val mode does not
    shuffle, so the points_cuv rows still line up)."""

    def __init__(self, **kwargs):
        pass

    def __call__(self, sample, info):
        frame = {
            "points": sample["points"].astype(np.float32),
            "metadata": sample.get("metadata", {"token": info.get("token")}),
        }
        if "voxels" in sample:
            vox = sample["voxels"]
            frame["voxels"] = vox["voxels"].astype(np.float32)
            frame["coordinates"] = vox["coordinates"]
            frame["num_points_per_voxel"] = vox["num_points"]
        if sample["mode"] == "train" and "targets" in sample:
            frame["voxel_sem_labels"] = sample["targets"]["voxel_sem_labels"]
            frame["point_sem_labels"] = sample["targets"]["point_sem_labels"]
        elif sample["mode"] == "train" and "annotations" in sample:
            # no host voxelization: point labels only
            frame["point_sem_labels"] = sample["annotations"][
                "point_sem_labels"]
        if "points_cuv" in sample:
            frame["points_cuv"] = sample["points_cuv"].astype(np.float32)
            frame["images"] = sample["images"].astype(np.float32)
            if "images_sem_labels" in sample:
                frame["images_sem_labels"] = sample["images_sem_labels"]
        if sample.get("num_tta_transforms", 0) > 0:
            variants = [frame]
            for i in range(1, sample["num_tta_transforms"]):
                v = sample[f"tta_{i}_voxels"]
                var = {"points": sample[f"tta_{i}_points"].astype(np.float32),
                       "voxels": v["voxels"].astype(np.float32),
                       "coordinates": v["coordinates"],
                       "num_points_per_voxel": v["num_points"],
                       "metadata": frame["metadata"]}
                for k in ("points_cuv", "images", "images_sem_labels"):
                    if k in frame:
                        var[k] = frame[k]
                variants.append(var)
            return variants, info
        return frame, info


@PIPELINES.register_module
class SegImagePreprocess:
    """Camera images: each camera resized to the common shape (its points'
    pixel coordinates and its label map with it), in training augmented
    (horizontal flip, colour jitter, JPEG compression, rescale, crop; each
    as configured), normalized per camera into one preallocated block, and
    the per-point points_cuv = [valid, norm_cam, norm_v, norm_u] in
    [-1, 1], in the shuffled point order."""

    def __init__(self, cfg=None, **kwargs):
        cfg = cfg or {}
        self.shuffle_points = cfg.get("shuffle_points", False)
        self.random_horizon_flip = cfg.get("random_horizon_flip", False)
        self.color_jitter_cfg = cfg.get("random_color_jitter_cfg", None)
        self.jpeg_cfg = cfg.get("random_jpeg_compression_cfg", None)
        self.rescale_cfg = cfg.get("random_rescale_cfg", None)
        self.crop_cfg = cfg.get("random_crop_cfg", None)
        self.no_augmentation = cfg.get("no_augmentation", False)

    def _augment(self, img, cp, lab, rng):
        if self.random_horizon_flip:
            img, cp[:, 1], lab = T.random_horizontal_flip(img, cp[:, 1], lab,
                                                          rng)
        if self.color_jitter_cfg is not None:
            img = T.color_jitter(img, rng, **self.color_jitter_cfg)
        if self.jpeg_cfg is not None:
            img = T.jpeg_compression(img, rng, **self.jpeg_cfg)
        if self.rescale_cfg is not None:
            img, cp, lab = T.random_rescale(img, cp, lab, rng,
                                            **self.rescale_cfg)
        if self.crop_cfg is not None:
            img, cp, lab = T.random_crop(img, cp, lab, rng, **self.crop_cfg)
        return img, cp, lab

    def __call__(self, sample, info):
        augment = sample["mode"] == "train" and not self.no_augmentation
        rng = sample.get("rng") or np.random.default_rng()
        cam_names = info["cam"]["names"]
        cam_attributes = info["cam"]["attributes"]
        resized_shape = info["cam"]["resized_shape"]  # (W, H)
        points_cp = sample["points_cp"].copy()
        labels = sample.get("image_sem_labels")
        out_images, out_labels = [], []
        for ci, (cam_id, img) in enumerate(zip(cam_names, sample["images"])):
            sel = points_cp[:, 0] == int(cam_id)
            lab = labels[ci] if labels is not None else None
            img, cp, lab = T.resize_image_points_label(
                img, points_cp[sel], lab, resized_shape)
            if augment:
                img, cp, lab = self._augment(img, cp, lab, rng)
            points_cp[sel] = cp
            out_images.append(img)
            if lab is not None:
                out_labels.append(lab)
        shapes = {im.shape[:2] for im in out_images}
        if len(shapes) != 1:
            raise ValueError(f"inconsistent camera shapes: {shapes}")
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
        if out_labels:
            sample["images_sem_labels"] = np.stack(out_labels, axis=0).astype(
                np.int32)
        return sample, info
