"""Panoptic instance tooling (own copy of
lidarseg3d_tpu/datasets/pipelines/instance_aug.py): the cut-out library
of thing-class instances (``save_instance``, Panoptic-PolarNet's instance
preparation) and the paste augmentation (``SegInstanceAug``): stored
instances are drawn, turned about the sensor's z axis by a random angle
and mirrored in y at random, and appended to the scan with their
semantic labels. The draws come from the sample's ``rng``, in the JAX
package's order, so the same generator gives the same scan.
"""

import os
import os.path as osp
import pickle

import numpy as np

from ..registry import PIPELINES


def save_instance(files, learning_map_lut, thing_list, out_dir,
                  min_points=10, root_marker="/sequences/"):
    """Cut every thing-class instance of at least ``min_points`` points out
    of the scans ``files`` (velodyne .bin paths; a scan's labels are its
    path with velodyne -> labels, .bin -> .label). Writes
    ``out_dir/instances_in_sequences/<seq>/instance/<frame>_<i>.bin``
    ([n, 4] float32) and ``out_dir/instance_path.pkl`` {train id: [paths]};
    -> the pkl's path."""
    instance_dict = {int(label): [] for label in thing_list}
    for data_path in files:
        raw = np.fromfile(data_path, dtype=np.float32).reshape(-1, 4)
        label_path = data_path.replace("velodyne", "labels")[:-3] + "label"
        ann = np.fromfile(label_path, dtype=np.uint32).reshape(-1)
        sem = learning_map_lut[ann & 0xFFFF]
        thing_mask = np.isin(sem, thing_list)
        inst_count = 0
        # an instance is a full label word (semantic + instance bits)
        for uid in np.unique(ann[thing_mask]):
            index = np.where(ann == uid)[0]
            if index.size < min_points:
                continue
            class_label = int(sem[index[0]])
            rel = (data_path.split(root_marker, 1)[1]
                   if root_marker in data_path else osp.basename(data_path))
            out = osp.join(out_dir, "instances_in_sequences",
                           rel.replace("velodyne", "instance")[:-4]
                           + f"_{inst_count}.bin")
            os.makedirs(osp.dirname(out), exist_ok=True)
            raw[index].astype(np.float32).tofile(out)
            instance_dict[class_label].append(out)
            inst_count += 1
    pkl = osp.join(out_dir, "instance_path.pkl")
    with open(pkl, "wb") as f:
        pickle.dump(instance_dict, f)
    return pkl


@PIPELINES.register_module
class SegInstanceAug:
    """Paste stored thing-class instances into a labelled scan (frames
    without labels pass unchanged). cfg: ``instance_pkl`` (the library),
    ``max_instances`` (per scan, default 10; the count is drawn in [0,
    max]), ``random_rotate`` / ``random_flip`` (default True), ``classes``
    (a subset of the thing train ids to paste)."""

    def __init__(self, cfg=None, **kwargs):
        cfg = dict(cfg or {})
        self.pkl_path = cfg.get("instance_pkl")
        self.max_instances = int(cfg.get("max_instances", 10))
        self.random_rotate = bool(cfg.get("random_rotate", True))
        self.random_flip = bool(cfg.get("random_flip", True))
        self.classes = cfg.get("classes")
        self._lib = None

    def _library(self):
        if self._lib is None:
            with open(self.pkl_path, "rb") as f:
                lib = pickle.load(f)
            if self.classes is not None:
                lib = {c: lib.get(c, []) for c in self.classes}
            self._lib = {c: v for c, v in lib.items() if v}
        return self._lib

    def __call__(self, sample, info):
        anno = sample.get("annotations")
        if not self.pkl_path or anno is None \
                or "point_sem_labels" not in anno or not self._library():
            return sample, info
        lib = self._library()
        rng = sample.get("rng") or np.random.default_rng()
        points = sample["points"]
        labels = anno["point_sem_labels"]
        inst = anno.get("point_inst_labels")
        add_pts, add_lab = [], []
        classes = list(lib.keys())
        for _ in range(int(rng.integers(0, self.max_instances + 1))):
            c = int(classes[rng.integers(len(classes))])
            path = lib[c][int(rng.integers(len(lib[c])))]
            pts = np.fromfile(path, dtype=np.float32).reshape(-1, 4).copy()
            if self.random_rotate:
                th = rng.uniform(0, 2 * np.pi)
                ct, st = np.cos(th), np.sin(th)
                x = pts[:, 0] * ct - pts[:, 1] * st
                y = pts[:, 0] * st + pts[:, 1] * ct
                pts[:, 0], pts[:, 1] = x, y
            if self.random_flip and rng.random() < 0.5:
                pts[:, 1] = -pts[:, 1]
            if pts.shape[1] < points.shape[1]:
                pts = np.concatenate([pts, np.zeros(
                    (len(pts), points.shape[1] - pts.shape[1]), np.float32)],
                    axis=1)
            add_pts.append(pts[:, : points.shape[1]])
            add_lab.append(np.full(len(pts), c, labels.dtype))
        if add_pts:
            sample["points"] = np.concatenate([points] + add_pts)
            anno["point_sem_labels"] = np.concatenate([labels] + add_lab)
            if inst is not None:
                anno["point_inst_labels"] = np.concatenate(
                    [inst, np.zeros(sum(len(p) for p in add_pts),
                                    inst.dtype)])
        return sample, info
