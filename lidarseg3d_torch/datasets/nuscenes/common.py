"""nuScenes-lidarseg info creation without the nuscenes devkit (own copy
of lidarseg3d_tpu/datasets/nuscenes/common.py).

The nuScenes tables are plain JSON files, read directly. Per annotated
sample the infos hold the lidar and lidarseg paths, ``ref_to_global``,
per camera ``cams_from_global``, the intrinsics and the image path, the
previous sweeps for multi-sweep input (``sweep_to_ref``, ``time_lag``),
and, when the tree has annotations, the detection boxes in the LIDAR_TOP
frame. Scenes are split by the official lists (``splits.py``).
"""

import json
import os
import os.path as osp
import pickle

import numpy as np


def quaternion_to_rotation(q):
    """[w, x, y, z] -> 3x3 rotation matrix."""
    w, x, y, z = q
    n = w * w + x * x + y * y + z * z
    s = 0.0 if n == 0 else 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array([
        [1 - (yy + zz), xy - wz, xz + wy],
        [xy + wz, 1 - (xx + zz), yz - wx],
        [xz - wy, yz + wx, 1 - (xx + yy)],
    ], dtype=np.float64)


def transform_matrix(translation, rotation_q, inverse=False):
    tm = np.eye(4, dtype=np.float64)
    rot = quaternion_to_rotation(rotation_q)
    if inverse:
        tm[:3, :3] = rot.T
        tm[:3, 3] = -rot.T @ np.asarray(translation)
    else:
        tm[:3, :3] = rot
        tm[:3, 3] = np.asarray(translation)
    return tm


class NuScenesTables:
    """Minimal nuScenes table reader (JSON files under <root>/<version>/)."""

    TABLES = [
        "sample", "sample_data", "scene", "calibrated_sensor", "ego_pose",
        "sensor", "lidarseg", "sample_annotation", "instance", "category",
    ]

    def __init__(self, root, version="v1.0-trainval"):
        self.root = root
        self.version = version
        self._tables = {}
        self._index = {}
        for t in self.TABLES:
            path = osp.join(root, version, f"{t}.json")
            if not osp.isfile(path):
                self._tables[t] = []
                self._index[t] = {}
                continue
            with open(path) as f:
                self._tables[t] = json.load(f)
            self._index[t] = {r["token"]: r for r in self._tables[t]}
        # lidarseg is keyed by sample_data token
        self.lidarseg_by_sd = {
            r["sample_data_token"]: r for r in self._tables["lidarseg"]
        }
        # annotations grouped by sample (the devkit's sample["anns"])
        self.anns_by_sample = {}
        for r in self._tables["sample_annotation"]:
            self.anns_by_sample.setdefault(r["sample_token"], []).append(r)

    def get(self, table, token):
        return self._index[table][token]

    def all(self, table):
        return self._tables[table]


def _sd_global_from_sensor(ts, sd):
    """sample_data record -> (sensor->global 4x4) via calibrated_sensor and
    ego_pose."""
    cs = ts.get("calibrated_sensor", sd["calibrated_sensor_token"])
    ep = ts.get("ego_pose", sd["ego_pose_token"])
    sensor_to_ego = transform_matrix(cs["translation"], cs["rotation"])
    ego_to_global = transform_matrix(ep["translation"], ep["rotation"])
    return ego_to_global @ sensor_to_ego, cs


# nuScenes category -> 10-class detection name (public mapping; cf.
# det3d/datasets/nuscenes/semanticnusc_common.py general_to_detection)
GENERAL_TO_DETECTION = {
    "human.pedestrian.adult": "pedestrian",
    "human.pedestrian.child": "pedestrian",
    "human.pedestrian.wheelchair": "ignore",
    "human.pedestrian.stroller": "ignore",
    "human.pedestrian.personal_mobility": "ignore",
    "human.pedestrian.police_officer": "pedestrian",
    "human.pedestrian.construction_worker": "pedestrian",
    "animal": "ignore",
    "vehicle.car": "car",
    "vehicle.motorcycle": "motorcycle",
    "vehicle.bicycle": "bicycle",
    "vehicle.bus.bendy": "bus",
    "vehicle.bus.rigid": "bus",
    "vehicle.truck": "truck",
    "vehicle.construction": "construction_vehicle",
    "vehicle.emergency.ambulance": "ignore",
    "vehicle.emergency.police": "ignore",
    "vehicle.trailer": "trailer",
    "movable_object.barrier": "barrier",
    "movable_object.trafficcone": "traffic_cone",
    "movable_object.pushable_pullable": "ignore",
    "movable_object.debris": "ignore",
    "static_object.bicycle_rack": "ignore",
}


def _annotation_velocity(ts, ann, max_time_diff=1.5):
    """Global-frame box velocity by centered difference of neighbouring
    annotations (devkit nuscenes.box_velocity semantics); [3], nan when
    inestimable."""
    has_prev, has_next = ann["prev"] != "", ann["next"] != ""
    if not has_prev and not has_next:
        return np.full(3, np.nan)
    first = ts.get("sample_annotation", ann["prev"]) if has_prev else ann
    last = ts.get("sample_annotation", ann["next"]) if has_next else ann
    pos_first = np.asarray(first["translation"], np.float64)
    pos_last = np.asarray(last["translation"], np.float64)
    t_first = ts.get("sample", first["sample_token"])["timestamp"] / 1e6
    t_last = ts.get("sample", last["sample_token"])["timestamp"] / 1e6
    dt = t_last - t_first
    if dt > max_time_diff or dt <= 0:
        return np.full(3, np.nan)
    return (pos_last - pos_first) / dt


def _sample_gt_boxes(ts, sample, ref_to_global, filter_zero=True):
    """Detection gt for one sample, in the LIDAR_TOP frame.

    Returns (gt_boxes [N, 9], gt_names [N]) in THIS repo's layout
    [x, y, z, dx(l), dy(w), dz(h), yaw, vx, vy] — yaw stays at column 6
    everywhere here; the reference packs [locs, wlh, vx, vy, -yaw-pi/2]
    (semanticnusc_common.py:488-498). nan velocities become 0."""
    g2r = np.linalg.inv(ref_to_global)
    boxes, names = [], []
    for ann in ts.anns_by_sample.get(sample["token"], []):
        cat = ts.get("category",
                     ts.get("instance", ann["instance_token"])
                     ["category_token"])["name"]
        name = GENERAL_TO_DETECTION.get(cat, "ignore")
        if filter_zero and (
                ann.get("num_lidar_pts", 0) + ann.get("num_radar_pts", 0)
                <= 0):
            continue
        c = g2r[:3, :3] @ np.asarray(ann["translation"]) + g2r[:3, 3]
        R = g2r[:3, :3] @ quaternion_to_rotation(ann["rotation"])
        yaw = np.arctan2(R[1, 0], R[0, 0])
        w, l, h = ann["size"]
        v = _annotation_velocity(ts, ann)
        v = np.where(np.isfinite(v), v, 0.0)
        v_l = (g2r[:3, :3] @ v)[:2]
        boxes.append([c[0], c[1], c[2], l, w, h, yaw, v_l[0], v_l[1]])
        names.append(name)
    return (np.asarray(boxes, np.float32).reshape(-1, 9),
            np.asarray(names, dtype=object))


def create_nuscenes_seg_infos(root, version="v1.0-trainval", nsweeps=1,
                              cam_chans=None, out_dir=None):
    """Build train/val info pkls for SemanticNuscDataset.

    Split assignment follows the OFFICIAL scene splits (700 train / 150 val
    for v1.0-trainval), vendored in datasets/nuscenes/splits.py so no devkit
    is needed (cf. reference semanticnusc_common.py:587 which imports them
    from nuscenes.utils.splits). Unknown versions fail loudly rather than
    silently mis-splitting.
    """
    ts = NuScenesTables(root, version)
    cam_chans = cam_chans or []

    from . import splits as nusc_splits

    if version == "v1.0-trainval":
        train_scenes = set(nusc_splits.train)
        val_scenes = set(nusc_splits.val)
    elif version == "v1.0-test":
        train_scenes = set()
        val_scenes = set(nusc_splits.test)
    elif version == "v1.0-mini":
        train_scenes = set(nusc_splits.mini_train)
        val_scenes = set(nusc_splits.mini_val)
    else:
        raise ValueError(
            f"unknown nuScenes version {version!r}: cannot assign official "
            "scene splits (expected v1.0-trainval / v1.0-test / v1.0-mini)"
        )

    infos_train, infos_val = [], []
    for scene in ts.all("scene"):
        sample_token = scene["first_sample_token"]
        while sample_token:
            sample = ts.get("sample", sample_token)
            sd_token = sample["data"]["LIDAR_TOP"]
            sd = ts.get("sample_data", sd_token)
            seg = ts.lidarseg_by_sd.get(sd_token)
            if seg is None:  # test split has no lidarseg
                seg_path = None
            else:
                seg_path = osp.join(root, seg["filename"])

            ref_to_global, _ = _sd_global_from_sensor(ts, sd)
            info = {
                "token": sample_token,
                # official lidarseg submissions are keyed by the LIDAR_TOP
                # sample_data token, not the sample token
                "lidar_sd_token": sd_token,
                "lidar_path": osp.join(root, sd["filename"]),
                "lidarseg_path": seg_path,
                "ref_to_global": ref_to_global.astype(np.float32),
                "timestamp": sd["timestamp"] / 1e6,
                "sweeps": [],
                # sequence bookkeeping for the tracking tools
                # (tools/nusc_tracking.py needs per-scene reset points)
                "scene_name": scene["name"],
                "first": sample["prev"] == "",
            }

            # detection gt (velocity included) when annotations exist
            if ts.anns_by_sample:
                gt_boxes, gt_names = _sample_gt_boxes(ts, sample,
                                                      ref_to_global)
                info["gt_boxes"] = gt_boxes
                info["gt_names"] = gt_names

            if cam_chans:
                cams_from_global, cam_intrinsics, cam_paths = {}, {}, {}
                for chan in cam_chans:
                    cam_sd = ts.get("sample_data", sample["data"][chan])
                    cam_to_global, cs = _sd_global_from_sensor(ts, cam_sd)
                    cams_from_global[chan] = np.linalg.inv(
                        cam_to_global
                    ).astype(np.float32)
                    cam_intrinsics[chan] = np.asarray(
                        cs["camera_intrinsic"], np.float32
                    )
                    cam_paths[chan] = osp.join(root, cam_sd["filename"])
                info["cams_from_global"] = cams_from_global
                info["cam_intrinsics"] = cam_intrinsics
                info["cam_paths"] = cam_paths

            # previous sweeps (non-keyframe lidar scans)
            prev = sd["prev"]
            global_from_ref_inv = np.linalg.inv(ref_to_global)
            while prev and len(info["sweeps"]) < nsweeps - 1:
                psd = ts.get("sample_data", prev)
                p_to_global, _ = _sd_global_from_sensor(ts, psd)
                info["sweeps"].append({
                    "lidar_path": osp.join(root, psd["filename"]),
                    "sweep_to_ref": (
                        global_from_ref_inv @ p_to_global
                    ).astype(np.float32),
                    "time_lag": info["timestamp"] - psd["timestamp"] / 1e6,
                })
                prev = psd["prev"]

            scene_name = scene["name"]
            if scene_name in val_scenes:
                infos_val.append(info)
            elif scene_name in train_scenes:
                infos_train.append(info)
            # else: scene not in this version's official splits
            sample_token = sample["next"]

    out_dir = out_dir or root
    os.makedirs(out_dir, exist_ok=True)
    tr = osp.join(out_dir, f"infos_train_{nsweeps:02d}sweeps_segdet.pkl")
    va = osp.join(out_dir, f"infos_val_{nsweeps:02d}sweeps_segdet.pkl")
    with open(tr, "wb") as f:
        pickle.dump(infos_train, f)
    with open(va, "wb") as f:
        pickle.dump(infos_val, f)
    return tr, va
