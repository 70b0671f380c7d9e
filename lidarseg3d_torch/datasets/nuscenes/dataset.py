"""nuScenes-lidarseg dataset (own copy of
lidarseg3d_tpu/datasets/nuscenes/dataset.py): info-driven samples (the
infos of ``common.create_nuscenes_seg_infos`` carry every path, so no
devkit is needed), the confusion-histogram mIoU over the 16 classes of
``metadata.LABELS_16``, and the test-split writer of
``{lidar_sd_token}_lidarseg.bin`` files (uint8 labels, the official
submission layout).
"""

import os
import os.path as osp
import pickle

import numpy as np

from ...core.seg_metrics import fast_hist_crop, per_class_iou
from ...parallel.dist import allreduce_hist
from ..pipelines.compose import Compose
from ..registry import DATASETS
from . import metadata as meta


@DATASETS.register_module
class SemanticNuscDataset:
    NumPointFeatures = 5  # x, y, z, intensity, ring index
    CLASSES = 17

    def __init__(self, info_path, root_path, nsweeps=1, load_interval=1,
                 pipeline=None, test_mode=False, class_names=None,
                 cam_names=None, cam_chan=None, cam_attributes=None,
                 img_resized_shape=None, version="v1.0-trainval", **kwargs):
        self._root_path = root_path
        self._info_path = info_path
        self.nsweeps = nsweeps
        self.test_mode = test_mode
        self._use_img = cam_names is not None
        self._num_point_features = (self.NumPointFeatures if nsweeps == 1
                                    else self.NumPointFeatures + 1)
        if self._use_img:
            self._cam_names = list(cam_names)
            self._cam_chan = list(cam_chan)
            self.img_resized_shape = tuple(img_resized_shape)  # (W, H)
            self._cam_attributes = {
                k: {"mean": np.asarray(v["mean"], np.float32),
                    "std": np.asarray(v["std"], np.float32)}
                for k, v in (cam_attributes or {}).items()}
        with open(info_path, "rb") as f:
            self._infos = pickle.load(f)
        if load_interval > 1:
            self._infos = self._infos[::load_interval]
        self._seg_paths = {i["token"]: i.get("lidarseg_path")
                           for i in self._infos}
        self.learning_map = meta.LEARNING_MAP
        self.num_classes = meta.NUM_CLASSES
        self.flag = np.ones(len(self), dtype=np.uint8)
        self.pipeline = Compose(pipeline) if pipeline is not None else None

    def __len__(self):
        return len(self._infos)

    def load_infos(self, idx):
        info = dict(self._infos[idx])
        info["remap_lut"] = meta.REMAP_LUT
        info["dim"] = {"points": self._num_point_features, "sem_labels": 1,
                       "inst_labels": 1}
        if self._use_img:
            info["cam"] = {"names": self._cam_names, "chan": self._cam_chan,
                           "attributes": self._cam_attributes,
                           "resized_shape": self.img_resized_shape}
        return info

    def get_sensor_data(self, idx, rng=None):
        info = self.load_infos(idx)
        sample = {
            "mode": "val" if self.test_mode else "train",
            "metadata": {"token": info["token"],
                         "num_point_features": self._num_point_features,
                         "lidarseg_path": info.get("lidarseg_path")},
            "nsweeps": self.nsweeps,
            "rng": rng,
        }
        data, _ = self.pipeline(sample, info)
        return data

    def __getitem__(self, idx):
        return self.get_sensor_data(idx)

    def get_anno_for_eval(self, token):
        raw = np.fromfile(self._seg_paths[token], dtype=np.uint8)
        return {"point_sem_labels":
                meta.REMAP_LUT[raw.astype(np.int64)].astype(np.uint8)}

    def evaluation(self, detections, output_dir=None, testset=False,
                   **kwargs):
        """detections: {token: {"pred_point_sem_labels": np.ndarray [n]}}.
        -> ({"results": {"mIoU": ..., class name: IoU}, "detail": {}},
        None), in percent; on the test split the predictions are written
        as ``OUTPUT_DIR/results_folder/lidarseg/test/{lidar_sd_token}
        _lidarseg.bin`` and (None, None) is returned."""
        if testset:
            out_dir = osp.join(output_dir or ".",
                               "results_folder/lidarseg/test")
            os.makedirs(out_dir, exist_ok=True)
            sd_by_sample = {i["token"]: i.get("lidar_sd_token", i["token"])
                            for i in self._infos}
            for token, pred in detections.items():
                labels = np.asarray(pred["pred_point_sem_labels"]).astype(
                    np.uint8)
                sd_token = sd_by_sample.get(token, token)
                labels.tofile(osp.join(out_dir, f"{sd_token}_lidarseg.bin"))
            return None, None

        unique_label = np.asarray(sorted(meta.LABELS_16.keys()))[1:] - 1
        unique_label_str = [meta.LABELS_16[x] for x in unique_label + 1]
        hist = 0
        for token, pred in detections.items():
            gt = self.get_anno_for_eval(token)["point_sem_labels"]
            pl = np.asarray(pred["pred_point_sem_labels"])
            if pl.shape[0] != gt.shape[0]:
                raise ValueError(
                    f"{token}: the prediction has {pl.shape[0]} points but "
                    f"the lidarseg file has {gt.shape[0]}: the config's "
                    "capacity.max_points must cover every scan (evaluation "
                    "counts all points)")
            hist = hist + fast_hist_crop(pl, gt, unique_label)
        hist = allreduce_hist(hist)
        ious = per_class_iou(hist)
        result = {"mIoU": float(np.nanmean(ious)) * 100}
        for cname, ciou in zip(unique_label_str, ious):
            result[cname] = ciou * 100
        return {"results": result, "detail": {}}, None
