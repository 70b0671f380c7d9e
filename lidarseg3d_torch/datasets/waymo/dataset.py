"""SemanticWaymo dataset (own copy of
lidarseg3d_tpu/datasets/waymo/dataset.py): the Waymo Open Dataset's 3D
semantic segmentation frames, pre-converted to one pkl per frame
(``converter.create_semanticwaymo_infos``, which needs tensorflow and
waymo_open_dataset; ``synthetic.write_semanticwaymo_tree`` writes a
seeded tree of the same layout). The labels are the 23 Waymo classes (0 =
undefined, ignored), already train ids.

Frame pkl layout:
  {"token": str,
   "lidars": {"points_xyz": [N, 3] f32, "points_feature": [N, 2] f32
                (intensity, elongation),
              "points_cp": [N, 3] f32  # [cam_id 1..5, w, h] in the
                                       # camera's own pixels; -100 = none
              "top_slices", "top_ri_indexing": the TOP lidar's points per
                return, for the submission writer},
   "annotations": {"point_sem_labels": [M] uint8, "num_seg_points": M},
       # the TOP lidar's returns; the pipeline pads them with 0 to N
   "cam_paths": {cam_id (str): JPEG path}}

The info pkl is a list of {"token", "path", "cam_paths", "sweeps", ...}.
"""

import os.path as osp
import pickle

import numpy as np

from ...core.seg_metrics import fast_hist_crop, per_class_iou
from ...parallel.dist import allreduce_hist
from ..pipelines.compose import Compose
from ..registry import DATASETS

CLASS_NAMES = [
    "undefined", "car", "truck", "bus", "other_vehicle", "motorcyclist",
    "bicyclist", "pedestrian", "sign", "traffic_light", "pole",
    "construction_cone", "bicycle", "motorcycle", "building", "vegetation",
    "tree_trunk", "curb", "road", "lane_marker", "other_ground", "walkable",
    "sidewalk",
]


@DATASETS.register_module
class SemanticWaymoDataset:
    NumPointFeatures = 5  # x, y, z, intensity, elongation
    CLASSES = 23

    def __init__(self, info_path, root_path, nsweeps=1, load_interval=1,
                 pipeline=None, test_mode=False, class_names=None,
                 cam_names=None, cam_attributes=None, img_resized_shape=None,
                 **kwargs):
        self._root_path = root_path
        self.nsweeps = nsweeps
        self.test_mode = test_mode
        self._use_img = cam_names is not None
        self._num_point_features = (self.NumPointFeatures if nsweeps == 1
                                    else self.NumPointFeatures + 1)
        if self._use_img:
            self._cam_names = list(cam_names)
            self.img_resized_shape = tuple(img_resized_shape)  # (W, H)
            self._cam_attributes = {
                k: {"mean": np.asarray(v["mean"], np.float32),
                    "std": np.asarray(v["std"], np.float32)}
                for k, v in (cam_attributes or {}).items()}
        with open(info_path, "rb") as f:
            self._infos = pickle.load(f)
        if load_interval > 1:
            self._infos = self._infos[::load_interval]
        self._by_token = {i["token"]: i for i in self._infos}
        self.num_classes = self.CLASSES
        self.flag = np.ones(len(self), dtype=np.uint8)
        self.pipeline = Compose(pipeline) if pipeline is not None else None

    def __len__(self):
        return len(self._infos)

    def _path(self, info):
        return (info["path"] if osp.isabs(info["path"])
                else osp.join(self._root_path, info["path"]))

    def load_infos(self, idx):
        info = dict(self._infos[idx])
        info["path"] = self._path(info)
        info["dim"] = {"points": self._num_point_features, "sem_labels": 1,
                       "inst_labels": 1}
        if self._use_img:
            info["cam"] = {"names": self._cam_names,
                           "attributes": self._cam_attributes,
                           "resized_shape": self.img_resized_shape}
        return info

    def get_sensor_data(self, idx, rng=None):
        info = self.load_infos(idx)
        sample = {
            "mode": "val" if self.test_mode else "train",
            "metadata": {"token": info["token"], "path": info["path"],
                         "num_point_features": self._num_point_features},
            "nsweeps": self.nsweeps,
            "rng": rng,
        }
        data, _ = self.pipeline(sample, info)
        return data

    def __getitem__(self, idx):
        return self.get_sensor_data(idx)

    def get_anno_for_eval(self, token):
        """The labelled points of a frame: the first ``num_seg_points``
        labels of its pkl (the TOP lidar's returns)."""
        with open(self._path(self._by_token[token]), "rb") as f:
            ann = pickle.load(f)["annotations"]
        labels = np.asarray(ann["point_sem_labels"])
        n_seg = ann.get("num_seg_points", len(labels))
        return {"point_sem_labels": labels[:n_seg].astype(np.uint8),
                "num_seg_points": n_seg}

    def evaluation(self, detections, output_dir=None, testset=False,
                   **kwargs):
        """detections: {token: {"pred_point_sem_labels": np.ndarray [n]}};
        each prediction is cut to the frame's labelled points.
        -> ({"results": {"mIoU": ..., class name: IoU}, "detail": {}},
        None), in percent, over classes 1-22. On the test split the
        official submission file is written, which needs
        waymo_open_dataset; without it this raises RuntimeError."""
        if testset:
            try:
                from .submission import write_segmentation_submission

                return write_segmentation_submission(
                    self, detections, output_dir), None
            except ImportError as e:
                raise RuntimeError(
                    "Waymo submission requires waymo_open_dataset: "
                    + str(e))
        unique_label = np.arange(1, self.CLASSES) - 1
        hist = 0
        for token, pred in detections.items():
            gt = self.get_anno_for_eval(token)["point_sem_labels"]
            pl = np.asarray(pred["pred_point_sem_labels"])[: len(gt)]
            hist = hist + fast_hist_crop(pl, gt, unique_label)
        hist = allreduce_hist(hist)
        ious = per_class_iou(hist)
        result = {"mIoU": float(np.nanmean(ious)) * 100}
        for c, ciou in zip(CLASS_NAMES[1:], ious):
            result[c] = ciou * 100
        return {"results": result, "detail": {}}, None
