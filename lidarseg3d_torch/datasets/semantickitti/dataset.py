"""SemanticKITTI dataset (own copy of
lidarseg3d_tpu/datasets/semantickitti/dataset.py): sequence scanning,
pipeline-driven samples, the confusion-histogram mIoU evaluation and the
test-split writer of .label files in the semantic-kitti-api layout, and
the panoptic instance library (``save_instance``) that SegInstanceAug
pastes from.
"""

import os
import os.path as osp

import numpy as np

from ...core.seg_metrics import fast_hist_crop, per_class_iou
from ...parallel.dist import allreduce_hist
from ..pipelines.compose import Compose
from ..registry import DATASETS
from . import metadata as meta


@DATASETS.register_module
class SemanticKITTIDataset:
    NumPointFeatures = 4

    def __init__(self, root_path, info_path=None, sequences=("00",),
                 nsweeps=1, load_interval=1, pipeline=None, test_mode=False,
                 ann_file=None, class_names=None, use_img=False,
                 cam_names=("1",), cam_attributes=None,
                 img_resized_shape=(1280, 384), **kwargs):
        self._root_path = root_path
        self.nsweeps = nsweeps
        self.test_mode = test_mode
        self._num_point_features = self.NumPointFeatures
        self._use_img = use_img
        self._cam_names = list(cam_names)
        self._cam_attributes = {
            k: {"mean": np.asarray(v["mean"], np.float32),
                "std": np.asarray(v["std"], np.float32)}
            for k, v in (cam_attributes or {}).items()}
        self.img_resized_shape = tuple(img_resized_shape)  # (W, H)

        files, frame_names = [], []
        for seq in sequences:
            vdir = osp.join(root_path, seq, "velodyne")
            if not osp.isdir(vdir):
                continue
            names = sorted(os.listdir(vdir))
            frame_names.extend(osp.join(seq, "velodyne", n) for n in names)
            files.extend(osp.join(vdir, n) for n in names)
        if load_interval > 1:
            files = files[::load_interval]
            frame_names = frame_names[::load_interval]
        self.files = files
        self.frame_names = frame_names

        self.learning_map = meta.LEARNING_MAP
        self.learning_map_inv = meta.LEARNING_MAP_INV
        self.labels = meta.LABELS
        self.num_classes = meta.NUM_CLASSES
        self.pipeline = Compose(pipeline) if pipeline is not None else None

    def __len__(self):
        return len(self.files)

    def load_infos(self, idx):
        info = {
            "path": self.files[idx],
            "token": self.frame_names[idx],
            "remap_lut": meta.REMAP_LUT,
            "dim": {"points": self._num_point_features, "sem_labels": 1,
                    "inst_labels": 1},
        }
        if self._use_img:
            info["cam"] = {"names": self._cam_names,
                           "attributes": self._cam_attributes,
                           "resized_shape": self.img_resized_shape}
        return info

    def get_sensor_data(self, idx, rng=None):
        info = self.load_infos(idx)
        sample = {
            "mode": "val" if self.test_mode else "train",
            "metadata": {"token": info["token"],
                         "num_point_features": self._num_point_features},
            "rng": rng,
        }
        data, _ = self.pipeline(sample, info)
        return data

    def __getitem__(self, idx):
        return self.get_sensor_data(idx)

    def get_anno_for_eval(self, token):
        path = osp.join(self._root_path, token)
        label_path = (path.replace("velodyne", "labels")
                      .replace(".bin", ".label"))
        raw = np.fromfile(label_path, dtype=np.uint32).reshape(-1)
        sem = meta.REMAP_LUT[(raw & 0xFFFF).astype(np.int64)]
        return {"point_sem_labels": sem.astype(np.uint8)}

    def save_instance(self, out_dir, min_points=10):
        """Write the thing-class instances of every scan and the library
        ``out_dir/instance_path.pkl`` (pipelines/instance_aug.py
        ``save_instance``); -> its path."""
        from ..pipelines.instance_aug import save_instance

        thing_list = [c for c, is_thing in meta.THING_CLASS.items()
                      if is_thing]
        return save_instance(self.files, meta.REMAP_LUT, thing_list,
                             out_dir, min_points=min_points)

    def evaluation(self, detections, output_dir=None, testset=False,
                   **kwargs):
        """detections: {token: {"pred_point_sem_labels": np.ndarray [n]}}.
        -> ({"results": {"mIoU": ..., class name: IoU}, "detail": {}},
        None), in percent; on the test split the predictions are written
        as .label files and (None, None) is returned."""
        if testset:
            print("Generating predictions for the test split")
            for token, pred in detections.items():
                labels = np.asarray(pred["pred_point_sem_labels"]).astype(
                    np.uint32)
                out = osp.join(output_dir or ".", "out/SemKITTI_test")
                save_path = osp.join(
                    out, "sequences",
                    token.replace("velodyne", "predictions")[:-3] + "label")
                os.makedirs(osp.dirname(save_path), exist_ok=True)
                labels[:, None].tofile(save_path)
            return None, None

        names = meta.class_names()
        unique_label = np.asarray(sorted(names.keys()))[1:] - 1
        unique_label_str = [names[x] for x in unique_label + 1]
        hist = 0
        for token, pred in detections.items():
            gt = self.get_anno_for_eval(token)["point_sem_labels"]
            pl = np.asarray(pred["pred_point_sem_labels"])
            if pl.shape[0] != gt.shape[0]:
                raise ValueError(
                    f"{token}: the prediction has {pl.shape[0]} points but "
                    f"the label file has {gt.shape[0]}: the config's "
                    "capacity.max_points must cover every scan (evaluation "
                    "counts all points)")
            hist = hist + fast_hist_crop(pl, gt, unique_label)
        hist = allreduce_hist(hist)
        ious = per_class_iou(hist)
        miou = float(np.nanmean(ious))
        result = {"mIoU": miou * 100}
        for cname, ciou in zip(unique_label_str, ious):
            result[cname] = ciou * 100
        return {"results": result, "detail": {}}, None
