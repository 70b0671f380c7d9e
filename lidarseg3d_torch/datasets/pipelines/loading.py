"""Point cloud and image loading stages, SemanticKITTI and nuScenes
branches (own copy of lidarseg3d_tpu/datasets/pipelines/loading.py
without cv2).

SemanticKITTI: .bin scans are float32 [x, y, z, intensity] rows; each
point gets its camera projection through P2 @ Tr of the sequence's
calib.txt; the labels file of a scan holds uint32 words: the semantic id
in the low 16 bits (mapped through the learning map), the instance id
above.

nuScenes: LIDAR_TOP .pcd.bin scans are float32 [x, y, z, intensity, ring]
rows; with ``nsweeps > 1`` the earlier sweeps of the infos are moved into
the key frame (``sweep_to_ref``) and every row gets a time-lag column (0
for the key frame); each point gets its projection into the six cameras
through ``ref_to_global``, ``cams_from_global`` and the intrinsics, in
float64; the lidarseg file holds one uint8 raw id per key-frame point.

SemanticWaymo: a frame is one pkl of the converter
(datasets/waymo/dataset.py): ``points_xyz`` || ``points_feature`` gives
[x, y, z, intensity, elongation] rows, ``points_cp`` each point's [cam_id,
w, h] in that camera's own pixels as stored; with ``nsweeps > 1`` the
earlier frames of the infos' ``sweeps`` are moved into the key frame by
``p @ T[:3, :3].T + T[:3, 3]`` with a time-lag column, and their points
get no camera (-100); the labels (the TOP lidar's returns) are padded
with 0 up to the point count.

Images are read by png.read_png_bgr (SemanticKITTI) and
jpeg_read.read_jpeg_bgr (nuScenes by channel, Waymo by camera id), which
give what cv2.imread gives. The image label maps are drawn as cv2.circle
draws a filled circle (``circle_offsets``, ``splat_circles``).
"""

import pickle

import numpy as np

from ..registry import PIPELINES
from .jpeg_read import read_jpeg_bgr
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


PORTED = ("SemanticKITTIDataset", "SemanticNuscDataset",
          "SemanticWaymoDataset")


def _not_ported(kind):
    return NotImplementedError(
        f"{kind}: lidarseg3d_torch loads {', '.join(PORTED)}; the detection "
        "configs read these datasets too, their boxes through the stages of "
        "datasets/pipelines/det_pipeline.py")


def _waymo_points(obj):
    lid = obj["lidars"]
    return np.concatenate([lid["points_xyz"], lid["points_feature"]],
                          axis=1).astype(np.float32)


def circle_offsets(radius):
    """(dy, dx) int64 [K, 2] of the pixels a filled ``cv2.circle`` of
    ``radius`` (8-connected, no sub-pixel shift) sets around its centre:
    cv2's midpoint walk, filling the rows +-dy with [-dx, dx] and the rows
    +-dx with [-dy, dy] at each step."""
    half = {}
    err, dx, dy, plus, minus = 0, radius, 0, 1, 2 * radius - 1
    while dx >= dy:
        for row, w in ((dy, dx), (-dy, dx), (dx, dy), (-dx, dy)):
            half[row] = max(half.get(row, -1), w)
        dy += 1
        err += plus
        plus += 2
        mask = (err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2
    return np.array([(r, c) for r, w in sorted(half.items())
                     for c in range(-w, w + 1)], np.int64)


def splat_circles(shape, xs, ys, labels, radius):
    """uint8 [H, W] map with a filled circle of ``radius`` and value
    labels[i] at (int(xs[i]), int(ys[i])) for each point whose label is
    above 0, drawn in order (a later circle overwrites an earlier one)
    and clipped at the border, as cv2.circle draws them one by one."""
    H, W = shape
    out = np.zeros(H * W, np.uint8)
    keep = np.flatnonzero(labels > 0)
    off = circle_offsets(radius)
    py = ys[keep].astype(np.int64)[:, None] + off[None, :, 0]
    px = xs[keep].astype(np.int64)[:, None] + off[None, :, 1]
    inside = (py >= 0) & (py < H) & (px >= 0) & (px < W)
    pix = (py * W + px)[inside]
    lab = np.broadcast_to(labels[keep][:, None], py.shape)[inside]
    # the last point to cover a pixel is the first in reversed order
    pix, first = np.unique(pix[::-1], return_index=True)
    out[pix] = lab[::-1][first]
    return out.reshape(H, W)


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
        if self.type == "SemanticKITTIDataset":
            points = np.fromfile(info["path"], dtype=np.float32).reshape(
                -1, 4)
            sample["points"] = points
            if self.use_img:
                sample["points_cp"] = self._kitti_points_cp(points,
                                                            info["path"])
        elif self.type == "SemanticNuscDataset":
            points = np.fromfile(info["lidar_path"],
                                 dtype=np.float32).reshape(-1, 5)
            nsweeps = sample.get("nsweeps", 1)
            if nsweeps > 1:
                rows = [np.concatenate(
                    [points, np.zeros((len(points), 1), np.float32)], 1)]
                for sw in info["sweeps"][: nsweeps - 1]:
                    p = np.fromfile(sw["lidar_path"],
                                    dtype=np.float32).reshape(-1, 5)
                    hom = np.concatenate(
                        [p[:, :3], np.ones((len(p), 1), np.float32)], 1)
                    p[:, :3] = (sw["sweep_to_ref"] @ hom.T).T[:, :3]
                    lag = np.full((len(p), 1), sw["time_lag"], np.float32)
                    rows.append(np.concatenate([p, lag], 1))
                points = np.concatenate(rows, 0)
            sample["points"] = points
            if self.use_img:
                sample["points_cp"] = self._nusc_points_cp(points, info)
        elif self.type == "SemanticWaymoDataset":
            with open(info["path"], "rb") as f:
                obj = pickle.load(f)
            sample["waymo_obj"] = obj
            points = _waymo_points(obj)
            # a frame without a previous one (a context's first) still
            # gets the time-lag column, so every frame of a multi-sweep
            # config has the same width (the JAX package's has one less)
            if sample.get("nsweeps", 1) > 1:
                rows = [np.concatenate(
                    [points, np.zeros((len(points), 1), np.float32)], 1)]
                for sw in info.get("sweeps", [])[: sample["nsweeps"] - 1]:
                    with open(sw["path"], "rb") as f:
                        p = _waymo_points(pickle.load(f))
                    T = np.asarray(sw["sweep_to_ref"], np.float32)
                    p[:, :3] = p[:, :3] @ T[:3, :3].T + T[:3, 3]
                    lag = np.full((len(p), 1), sw["time_lag"], np.float32)
                    rows.append(np.concatenate([p, lag], 1))
                points = np.concatenate(rows, 0)
            sample["points"] = points
            if self.use_img:
                cp = obj["lidars"]["points_cp"].astype(np.float32)
                if len(cp) < len(points):
                    cp = np.concatenate([cp, np.full(
                        (len(points) - len(cp), cp.shape[1]), -100.0,
                        np.float32)])
                sample["points_cp"] = cp
        else:
            raise _not_ported(self.type)
        return sample, info

    @staticmethod
    def _nusc_points_cp(points, info):
        """Per-point [cam_id, w, h] through lidar -> global -> camera ->
        image in float64, cam_id 1-based in cam_chan order (a later camera
        overwrites an earlier one), invalid rows -100; a point counts when
        it is in front of the camera and strictly inside (1, 1599) x
        (1, 899) of the 1600x900 image."""
        im_h, im_w = 900, 1600
        cp = np.full((len(points), 3), -100.0, np.float32)
        hom = np.concatenate(
            [points[:, :3], np.ones((len(points), 1), np.float32)], 1)
        pts_global = info["ref_to_global"].astype(np.float64) @ hom.T
        for cam_id, chan in enumerate(info["cam"]["chan"]):
            pts_cam = (info["cams_from_global"][chan].astype(np.float64)
                       @ pts_global)[:3]
            uvw = np.asarray(info["cam_intrinsics"][chan], np.float64) \
                @ pts_cam
            uv = uvw[:2] / np.maximum(uvw[2:3], 1e-6)
            mask = ((pts_cam[2] > 0) & (uv[0] > 1) & (uv[0] < im_w - 1)
                    & (uv[1] > 1) & (uv[1] < im_h - 1))
            cp[mask, 0] = cam_id + 1
            cp[mask, 1] = uv[0][mask]
            cp[mask, 2] = uv[1][mask]
        return cp


@PIPELINES.register_module
class LoadImageFromFile:
    """BGR reads of the frame's camera set: the image_2 PNG of a
    SemanticKITTI scan, the JPEGs of a nuScenes sample by channel, those
    of a Waymo frame by camera id (from the info's ``cam_paths``, else
    the frame pkl's)."""

    def __init__(self, use_img=True, **kwargs):
        self.use_img = use_img

    def __call__(self, sample, info):
        if not self.use_img:
            return sample, info
        if sample["type"] == "SemanticKITTIDataset":
            img_path = (info["path"].replace("velodyne", "image_2")
                        .replace(".bin", ".png"))
            sample["images"] = [read_png_bgr(img_path)
                                for _ in info["cam"]["names"]]
        elif sample["type"] == "SemanticNuscDataset":
            sample["images"] = [read_jpeg_bgr(info["cam_paths"][c])
                                for c in info["cam"]["chan"]]
        elif sample["type"] == "SemanticWaymoDataset":
            paths = info.get("cam_paths") or sample["waymo_obj"]["cam_paths"]
            sample["images"] = [read_jpeg_bgr(paths[c])
                                for c in info["cam"]["names"]]
        else:
            raise _not_ported(sample["type"])
        return sample, info


@PIPELINES.register_module
class LoadPointCloudAnnotations:
    """Per-point semantic (and, for SemanticKITTI, instance) labels of a
    scan; with several nuScenes sweeps only the key frame's points are
    labelled, the others get 0; a Waymo frame's labels (its TOP lidar's
    returns) are padded with 0 up to the point count."""

    def __init__(self, with_bbox=False, **kwargs):
        self.with_bbox = with_bbox

    def __call__(self, sample, info):
        if sample["type"] == "SemanticKITTIDataset":
            label_path = (info["path"].replace("velodyne", "labels")
                          .replace(".bin", ".label"))
            raw = np.fromfile(label_path, dtype=np.uint32).reshape(-1)
            sem = (raw & 0xFFFF).astype(np.int64)
            inst = (raw >> 16).astype(np.int64)
            sample["annotations"] = {
                "point_sem_labels": info["remap_lut"][sem].astype(np.int32),
                "point_inst_labels": inst.astype(np.int32)}
        elif sample["type"] == "SemanticNuscDataset":
            raw = np.fromfile(info["lidarseg_path"],
                              dtype=np.uint8).reshape(-1)
            sem = info["remap_lut"][raw.astype(np.int64)].astype(np.int32)
            n = len(sample["points"])
            if n > len(sem):
                sem = np.concatenate([sem, np.zeros(n - len(sem), np.int32)])
            sample["annotations"] = {"point_sem_labels": sem,
                                     "point_inst_labels": np.zeros(
                                         n, np.int32)}
        elif sample["type"] == "SemanticWaymoDataset":
            sem = np.asarray(sample["waymo_obj"]["annotations"][
                "point_sem_labels"], np.int32)
            n = len(sample["points"])
            if n > len(sem):
                sem = np.concatenate([sem, np.zeros(n - len(sem), np.int32)])
            sample["annotations"] = {"point_sem_labels": sem[:n],
                                     "point_inst_labels": np.zeros(
                                         n, np.int32)}
        else:
            raise _not_ported(sample["type"])
        return sample, info


@PIPELINES.register_module
class LoadImageAnnotations:
    """Sparse pixel labels of each camera: every projected point with a
    label above 0 splats its label as a filled circle of
    ``points_cp_radius`` into a uint8 map of the camera's image size."""

    def __init__(self, points_cp_radius=1, use_img=True, **kwargs):
        self.points_cp_radius = points_cp_radius
        self.use_img = use_img

    def __call__(self, sample, info):
        if not self.use_img:
            return sample, info
        points_cp = sample["points_cp"]
        labels = sample["annotations"]["point_sem_labels"]
        maps = []
        for cam_id, img in zip(info["cam"]["names"], sample["images"]):
            sel = points_cp[:, 0] == int(cam_id)
            maps.append(splat_circles(
                img.shape[:2], points_cp[sel, 1], points_cp[sel, 2],
                labels[sel], self.points_cp_radius))
        sample["image_sem_labels"] = maps
        return sample, info
