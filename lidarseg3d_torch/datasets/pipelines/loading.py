"""Point cloud and image loading stages, SemanticKITTI branches (own copy
of lidarseg3d_tpu/datasets/pipelines/loading.py without cv2).

KITTI .bin scans are float32 [x, y, z, intensity] rows; each point gets its
camera projection through P2 @ Tr of the sequence's calib.txt. Images are
read by png.read_png_bgr, which gives what cv2.imread gives. The nuScenes
and Waymo branches, and the annotation stages of the training pipeline,
are not ported yet and raise.
"""

import numpy as np

from ..registry import PIPELINES
from .png import read_png_bgr


def read_calib_semantickitti(calib_path):
    """Parse a SemanticKITTI calib.txt -> dict of P0..P3 [3,4] and Tr [4,4]."""
    out = {}
    with open(calib_path) as f:
        for line in f:
            if ":" not in line:
                continue
            key, vals = line.split(":", 1)
            arr = np.array([float(x) for x in vals.split()], np.float32)
            out[key.strip()] = arr.reshape(3, 4)
    tr = np.eye(4, dtype=np.float32)
    tr[:3, :4] = out["Tr"]
    out["Tr"] = tr
    return out


def select_points_in_frustum(pts_2d, x1, y1, x2, y2):
    return ((pts_2d[:, 0] >= x1) & (pts_2d[:, 0] < x2)
            & (pts_2d[:, 1] >= y1) & (pts_2d[:, 1] < y2))


def _not_ported(kind):
    return NotImplementedError(
        f"{kind} is not ported to lidarseg3d_torch yet (only "
        "SemanticKITTIDataset is)")


@PIPELINES.register_module
class LoadPointCloudFromFile:
    def __init__(self, dataset="SemanticKITTIDataset", use_img=False,
                 **kwargs):
        self.type = dataset
        self.use_img = use_img

    def _kitti_points_cp(self, points, path):
        """Per-point [cam_id, w, h] camera projection via P2 @ Tr; cam_id
        1-based, invalid rows -100."""
        calib_path = path[: -len("velodyne/000000.bin")] + "calib.txt"
        calib = read_calib_semantickitti(calib_path)
        proj = calib["P2"] @ calib["Tr"]  # [3, 4]
        hpts = np.concatenate(
            [points[:, :3], np.ones((len(points), 1), np.float32)], axis=1)
        img_pts = (proj @ hpts.T).T
        img_pts = img_pts[:, :2] / np.maximum(img_pts[:, 2:3], 1e-6)
        im_width, im_height = 1224, 370
        mask = select_points_in_frustum(img_pts, 0, 0, im_width, im_height)
        mask &= points[:, 0] > 0  # points in front of the car
        cp = np.full((len(points), 3), -100.0, np.float32)
        cp[mask, 0] = 1
        cp[mask, 1:3] = img_pts[mask]
        return cp

    def __call__(self, sample, info):
        sample["type"] = self.type
        if self.type != "SemanticKITTIDataset":
            raise _not_ported(self.type)
        points = np.fromfile(info["path"], dtype=np.float32).reshape(-1, 4)
        sample["points"] = points
        if self.use_img:
            sample["points_cp"] = self._kitti_points_cp(points, info["path"])
        return sample, info


@PIPELINES.register_module
class LoadImageFromFile:
    """BGR reads of the frame's camera set (the image_2 PNG of a
    SemanticKITTI scan)."""

    def __init__(self, use_img=True, **kwargs):
        self.use_img = use_img

    def __call__(self, sample, info):
        if not self.use_img:
            return sample, info
        if sample["type"] != "SemanticKITTIDataset":
            raise _not_ported(sample["type"])
        img_path = (info["path"].replace("velodyne", "image_2")
                    .replace(".bin", ".png"))
        cam_paths = {"1": img_path}
        sample["images"] = [read_png_bgr(cam_paths[c])
                            for c in info["cam"]["names"]]
        return sample, info
