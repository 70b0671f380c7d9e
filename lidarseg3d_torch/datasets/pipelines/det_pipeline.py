"""Detection data pipeline: gt loading, augmentation, gt sampling and
CenterPoint targets (own copy of
lidarseg3d_tpu/datasets/pipelines/det_pipeline.py), on the flat sample
dict of the port's pipelines:

- LoadDetAnnotations: the gt boxes and names of the frame pkl (Waymo
  converter annotations), else of the info (nuScenes infos carry 9-dim
  boxes with velocity);
- DetPreprocess: nuScenes points narrowed to CenterPoint's columns
  (``nusc_det_points``), class filtering, optional gt-database sampling
  (instance point sets pasted at non-colliding box poses), flip / rotation /
  scaling / translation of points and boxes together, every draw from
  the frame's generator in the JAX package's order; in train mode the
  points are also what SegVoxelization voxelizes (``points_with_labels``);
- DetAssignLabel: per-task gaussian heatmap targets
  (core/center_targets.py) and a padded gt_boxes_and_cls [max_objs, 8];
- DoubleFlip: the y-, x- and xy-flipped copies as TTA variants 1..3;
- DetReformat: the frame dict for the collate (4 rows under DoubleFlip);
- create_gt_database: the instance point sets and dbinfos_train.pkl the
  DBSampler reads.
"""

import os.path as osp
import pickle

import numpy as np

from ...core import box_np_ops as bnp
from ...core.center_targets import assign_center_targets
from ..registry import PIPELINES


@PIPELINES.register_module
class LoadDetAnnotations:
    """Read gt boxes from the frame object (Waymo converter annotations)
    or directly from the info row (nuScenes infos carry 9-dim
    [x,y,z,dx,dy,dz,yaw,vx,vy] boxes from _sample_gt_boxes)."""

    def __init__(self, **kwargs):
        pass

    def __call__(self, sample, info):
        obj = sample.get("waymo_obj") or sample.get("frame_obj")
        anns = (obj or {}).get("annotations", {})
        boxes = anns.get("gt_boxes")
        names = anns.get("gt_names")
        if boxes is None and isinstance(info, dict) and "gt_boxes" in info:
            boxes, names = info["gt_boxes"], info["gt_names"]
        if boxes is None:
            boxes = np.zeros((0, 7))
            names = np.zeros((0,), dtype=object)
        boxes = np.asarray(boxes, np.float32)
        D = boxes.shape[-1] if boxes.ndim == 2 and boxes.size else (
            boxes.shape[-1] if boxes.ndim == 2 else 7)
        sample["det_annotations"] = {
            "gt_boxes": boxes.reshape(-1, D),
            "gt_names": np.asarray(names).reshape(-1),
        }
        return sample, info


class DBSampler:
    """Ground-truth database sampler (DataBaseSamplerV2 equivalent).

    dbinfos: {class_name: [{"path", "box" [7], "num_points"}]} built by
    tools/create_gt_database.py. For each class with a sample_group quota,
    draws instances and keeps those whose boxes don't collide (rotated BEV)
    with existing gt or previously placed samples.
    """

    def __init__(self, db_info_path, sample_groups, min_points=5, rng=None,
                 root_path=""):
        with open(db_info_path, "rb") as f:
            self._infos = pickle.load(f)
        self._root = root_path
        # {class: target_count}
        self._groups = dict(sample_groups)
        self._min_points = min_points

    def sample_all(self, gt_boxes, gt_names, rng):
        gt_boxes = np.asarray(gt_boxes, np.float32)
        D = gt_boxes.shape[-1] if gt_boxes.ndim == 2 else 7
        placed_boxes = [gt_boxes.reshape(-1, D)]
        out_boxes, out_names, out_points = [], [], []
        for cls, quota in self._groups.items():
            have = int(np.sum(gt_names == cls))
            need = max(0, int(quota) - have)
            cands = [
                c for c in self._infos.get(cls, [])
                if c["num_points"] >= self._min_points
            ]
            if need == 0 or not cands:
                continue
            pick = rng.choice(len(cands), size=min(need * 2, len(cands)),
                              replace=False)
            taken = 0
            for i in pick:
                if taken >= need:
                    break
                cand = cands[int(i)]
                box = np.asarray(cand["box"], np.float32).reshape(1, -1)
                if box.shape[-1] < D:
                    # db entries store 7-dim boxes; sampled (static) objects
                    # get zero velocity in a 9-dim pipeline
                    box = np.concatenate(
                        [box, np.zeros((1, D - box.shape[-1]), np.float32)],
                        axis=-1)
                cur = np.concatenate(placed_boxes, axis=0)
                if cur.size and bnp.boxes_bev_collide(box, cur).any():
                    continue
                path = cand["path"]
                if self._root and not osp.isabs(path):
                    path = osp.join(self._root, path)
                pts = np.fromfile(path, np.float32).reshape(
                    -1, cand.get("num_features", 4))
                placed_boxes.append(box)
                out_boxes.append(box[0])
                out_names.append(cls)
                out_points.append(pts)
                taken += 1
        if not out_boxes:
            return None
        return {
            "gt_boxes": np.stack(out_boxes),
            "gt_names": np.asarray(out_names, dtype=object),
            "points": np.concatenate(out_points, axis=0),
        }


def nusc_det_points(points):
    """CenterPoint's nuScenes detection points [x, y, z, intensity, time
    lag] of the loader's [x, y, z, intensity, ring(, time lag)] rows: the
    ring goes, and a single sweep gets a zero lag, as CenterPoint's loader
    gives them. The published nuScenes detection configs read these 5
    columns; the JAX package passes all 6 on and its reader's width
    assert stops them (ROADMAP §C)."""
    lag = (points[:, 5:6] if points.shape[1] > 5
           else np.zeros((len(points), 1), points.dtype))
    return np.concatenate([points[:, :4], lag], axis=1)


@PIPELINES.register_module
class DetPreprocess:
    def __init__(self, cfg=None, **kwargs):
        cfg = dict(cfg or {})
        self.mode = cfg["mode"]
        self.shuffle_points = cfg.get("shuffle_points", False)
        self.class_names = list(cfg.get("class_names", []))
        self.min_points_in_gt = cfg.get("min_points_in_gt", -1)
        self.no_augmentation = cfg.get("no_augmentation", False)
        self.global_rot_noise = cfg.get("global_rot_noise", [0.0, 0.0])
        self.global_scale_noise = cfg.get("global_scale_noise", [1.0, 1.0])
        self.global_translate_std = cfg.get("global_translate_std", 0)
        db = cfg.get("db_sampler")
        self.db_sampler = DBSampler(**db) if db else None

    def __call__(self, sample, info):
        sample["mode"] = self.mode
        points = sample["points"]
        if sample.get("type") == "SemanticNuscDataset":
            points = nusc_det_points(points)
        rng = sample.get("rng") or np.random.default_rng()
        if self.mode != "train":
            if self.shuffle_points:
                points = points[rng.permutation(len(points))]
            sample["points"] = points
            return sample, info

        anns = sample["det_annotations"]
        boxes = anns["gt_boxes"]
        names = anns["gt_names"]
        keep = ~np.isin(names, ["DontCare", "ignore", "UNKNOWN"])
        boxes, names = boxes[keep], names[keep]

        if not self.no_augmentation:
            if self.min_points_in_gt > 0 and len(boxes):
                counts = bnp.points_in_rbbox(points, boxes).sum(axis=0)
                boxes, names = (boxes[counts >= self.min_points_in_gt],
                                names[counts >= self.min_points_in_gt])
            if self.db_sampler is not None:
                sampled = self.db_sampler.sample_all(boxes, names, rng)
                if sampled is not None:
                    boxes = np.concatenate([boxes, sampled["gt_boxes"]])
                    names = np.concatenate([names, sampled["gt_names"]])
                    pts = sampled["points"]
                    if pts.shape[1] < points.shape[1]:
                        pts = np.concatenate(
                            [pts, np.zeros((len(pts),
                                            points.shape[1] - pts.shape[1]),
                                           points.dtype)], axis=1)
                    points = np.concatenate([pts[:, :points.shape[1]],
                                             points])

        in_cls = np.isin(names, self.class_names)
        boxes, names = boxes[in_cls], names[in_cls]
        classes = np.array(
            [self.class_names.index(n) + 1 for n in names], np.int32)

        if not self.no_augmentation:
            boxes, points = bnp.random_flip_both(boxes, points, rng)
            boxes, points = bnp.global_rotation(
                boxes, points, self.global_rot_noise, rng)
            boxes, points = bnp.global_scaling(
                boxes, points, *self.global_scale_noise, rng=rng)
            boxes, points = bnp.global_translate(
                boxes, points, self.global_translate_std, rng)

        if self.shuffle_points:
            points = points[rng.permutation(len(points))]
        sample["points"] = points
        # SegVoxelization voxelizes "points_with_labels" in train mode; a
        # detection frame has no label channel. The JAX package's det
        # train pipelines stop there (ROADMAP §C); its tests set the key
        sample["points_with_labels"] = points
        sample["det_annotations"] = {
            "gt_boxes": boxes, "gt_names": names, "gt_classes": classes,
        }
        return sample, info


@PIPELINES.register_module
class DetAssignLabel:
    """CenterPoint target assignment (AssignLabel, preprocess.py:274)."""

    def __init__(self, cfg=None, **kwargs):
        cfg = dict(cfg or {})
        self.tasks = [dict(t) for t in cfg["tasks"]]
        self.pc_range = np.asarray(cfg["pc_range"], np.float32)
        self.voxel_size = np.asarray(cfg["voxel_size"], np.float32)
        self.out_size_factor = int(cfg.get("out_size_factor", 8))
        self.gaussian_overlap = cfg.get("gaussian_overlap", 0.1)
        self.max_objs = int(cfg.get("max_objs", 500))
        self.min_radius = cfg.get("min_radius", 2)

    def __call__(self, sample, info):
        if sample["mode"] != "train":
            return sample, info
        anns = sample["det_annotations"]
        boxes, classes = anns["gt_boxes"], anns["gt_classes"]
        # drop boxes whose center leaves the BEV range (Voxelization step
        # in the reference, preprocess.py:152)
        inb = (
            (boxes[:, 0] >= self.pc_range[0]) & (boxes[:, 0] < self.pc_range[3])
            & (boxes[:, 1] >= self.pc_range[1]) & (boxes[:, 1] < self.pc_range[4])
        )
        boxes, classes = boxes[inb], classes[inb]

        grid = np.round(
            (self.pc_range[3:5] - self.pc_range[0:2]) / self.voxel_size[:2]
        ).astype(int)
        hw = (int(grid[1]) // self.out_size_factor,
              int(grid[0]) // self.out_size_factor)
        # tasks own consecutive global class-id ranges, in the order the
        # config concatenates class_names (DetPreprocess assigns 1-based
        # global ids the same way)
        class_ids, off = [], 0
        for t in self.tasks:
            n = int(t["num_class"])
            class_ids.append(list(range(off, off + n)))
            off += n
        targets = assign_center_targets(
            boxes, classes - 1, class_ids, grid_hw=hw,
            voxel_size=list(self.voxel_size) + [1.0],
            pc_range=list(self.pc_range), out_factor=self.out_size_factor,
            max_objs=self.max_objs, min_overlap=self.gaussian_overlap,
        )
        sample["det_targets"] = targets
        max_gt = self.max_objs
        gtc = np.zeros((max_gt, 8), np.float32)
        n = min(len(boxes), max_gt)
        gtc[:n, :7] = boxes[:n, :7]  # RoI head refines geometry only
        gtc[:n, 7] = classes[:n]
        sample["gt_boxes_and_cls"] = gtc
        return sample, info


@PIPELINES.register_module
class DoubleFlip:
    """Detection double-flip TTA: append the y-flip (y=-y), x-flip (x=-x)
    and xy-flip copies of the point cloud as TTA variants 1..3 (the fixed
    order CenterHead._double_flip_maps un-flips). SegVoxelization voxelizes
    each variant; DetReformat emits 4 consecutive batch rows per frame.
    (CenterPoint's det3d/datasets/pipelines/test_aug.py:8-32.)
    """

    def __init__(self, **kwargs):
        pass

    def __call__(self, sample, info):
        pts = sample["points"]
        y = pts.copy()
        y[:, 1] = -y[:, 1]
        x = pts.copy()
        x[:, 0] = -x[:, 0]
        xy = pts.copy()
        xy[:, 0] = -xy[:, 0]
        xy[:, 1] = -xy[:, 1]
        sample["tta_1_points"] = y
        sample["tta_2_points"] = x
        sample["tta_3_points"] = xy
        sample["num_tta_transforms"] = 4
        sample["double_flip"] = True
        return sample, info


@PIPELINES.register_module
class DetReformat:
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
        for k in ("det_targets", "gt_boxes_and_cls"):
            if k in sample:
                frame[k] = sample[k]
        if sample.get("num_tta_transforms", 0) > 1 and "voxels" in sample:
            variants = [frame]
            for i in range(1, sample["num_tta_transforms"]):
                v = sample[f"tta_{i}_voxels"]
                variants.append({
                    "points": sample[f"tta_{i}_points"].astype(np.float32),
                    "voxels": v["voxels"].astype(np.float32),
                    "coordinates": v["coordinates"],
                    "num_points_per_voxel": v["num_points"],
                    "metadata": frame["metadata"],
                })
            return variants, info
        return frame, info


def create_gt_database(dataset, out_dir, class_names, min_points=1):
    """Extract per-instance point sets into a gt database (the JAX
    package's create_gt_database).

    dataset: any det dataset whose get_sensor_data yields samples with
    "points" and "det_annotations" (run with a pipeline ending BEFORE
    augmentation). Writes <out_dir>/gt_database/<cls>_<i>.bin and
    <out_dir>/dbinfos_train.pkl.
    """
    import os

    db_dir = osp.join(out_dir, "gt_database")
    os.makedirs(db_dir, exist_ok=True)
    infos = {c: [] for c in class_names}
    count = 0
    for idx in range(len(dataset)):
        sample = dataset.get_sensor_data(idx)
        if isinstance(sample, dict) and "det_annotations" in sample:
            anns = sample["det_annotations"]
            points = sample["points"]
        else:  # frame dict from a full pipeline: not supported
            raise ValueError("pipeline must keep det_annotations (end the "
                             "pipeline before DetReformat)")
        boxes, names = anns["gt_boxes"], anns["gt_names"]
        if not len(boxes):
            continue
        member = bnp.points_in_rbbox(points, boxes)
        for j, (box, name) in enumerate(zip(boxes, names)):
            if name not in infos:
                continue
            pts = points[member[:, j]]
            if len(pts) < min_points:
                continue
            # store points relative to the box center (sampler pastes at
            # the stored box pose, reference keeps absolute; relative lets
            # future re-posing — we keep ABSOLUTE for reference parity)
            path = osp.join(db_dir, f"{name}_{count}.bin")
            pts.astype(np.float32).tofile(path)
            infos[name].append({
                "path": path, "box": box.astype(np.float32),
                "num_points": int(len(pts)),
                "num_features": int(points.shape[1]),
            })
            count += 1
    db_path = osp.join(out_dir, "dbinfos_train.pkl")
    with open(db_path, "wb") as f:
        pickle.dump(infos, f)
    return db_path
