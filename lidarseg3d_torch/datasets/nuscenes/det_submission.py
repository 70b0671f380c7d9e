"""nuScenes detection submission writer, the official results JSON (own
copy of lidarseg3d_tpu/datasets/nuscenes/det_submission.py):
{"results": {sample_token: [box dicts]}, "meta": ...}, for the
nuscenes-devkit's ``python -m nuscenes.eval.detection.evaluate``. Boxes
[x, y, z, dx(l), dy(w), dz(h), yaw, (vx, vy)] in the LIDAR frame go to the
global frame by the info's ref_to_global, sizes as nuScenes' [w, l, h],
yaw as a quaternion, and each class's attribute at rest or moving
(|v| > 0.2 m/s).
"""

import json
import os

import numpy as np

NUSC_DET_NAMES = (
    "car", "truck", "construction_vehicle", "bus", "trailer", "barrier",
    "motorcycle", "bicycle", "pedestrian", "traffic_cone",
)

# CenterPoint's default attribute per class at rest; moving objects
# (|v| > 0.2 m/s) get the moving/with_rider attribute
_REST_ATTR = {
    "car": "vehicle.parked",
    "truck": "vehicle.parked",
    "construction_vehicle": "",
    "bus": "vehicle.stopped",
    "trailer": "vehicle.parked",
    "barrier": "",
    "motorcycle": "cycle.without_rider",
    "bicycle": "cycle.without_rider",
    "pedestrian": "pedestrian.standing",
    "traffic_cone": "",
}
_MOVING_ATTR = {
    "car": "vehicle.moving",
    "truck": "vehicle.moving",
    "construction_vehicle": "vehicle.moving",
    "bus": "vehicle.moving",
    "trailer": "vehicle.moving",
    "motorcycle": "cycle.with_rider",
    "bicycle": "cycle.with_rider",
    "pedestrian": "pedestrian.moving",
}


def _yaw_quaternion(yaw):
    return [float(np.cos(yaw / 2)), 0.0, 0.0, float(np.sin(yaw / 2))]


def detections_to_nusc_json(detections, infos, out_path,
                            class_names=NUSC_DET_NAMES, meta=None):
    """detections: {token: {box3d_lidar [N, 7], scores [N], label_preds [N],
    velocity [N, 2] (optional), valid [N] (optional)}}; infos: {token:
    info-with-ref_to_global}. Writes the official results JSON, returns
    the path."""
    results = {}
    for token, det in detections.items():
        info = infos[token]
        T = np.asarray(info["ref_to_global"], np.float64).reshape(4, 4)
        R = T[:3, :3]
        dyaw = np.arctan2(R[1, 0], R[0, 0])
        boxes = np.asarray(det["box3d_lidar"], np.float64).reshape(-1, 7)
        scores = np.asarray(det["scores"], np.float64).reshape(-1)
        labels = np.asarray(det["label_preds"], np.int64).reshape(-1)
        valid = np.asarray(det.get("valid", np.ones(len(boxes), bool)),
                           bool).reshape(-1)
        vel = np.asarray(det.get("velocity", np.zeros((len(boxes), 2))),
                         np.float64).reshape(-1, 2)
        annos = []
        for i in range(len(boxes)):
            if not valid[i]:
                continue
            b = boxes[i]
            c = R @ b[:3] + T[:3, 3]
            v3 = R @ np.array([vel[i, 0], vel[i, 1], 0.0])
            name = class_names[int(labels[i])]
            speed = float(np.hypot(v3[0], v3[1]))
            attr = (_MOVING_ATTR.get(name, "") if speed > 0.2
                    else _REST_ATTR.get(name, ""))
            annos.append({
                "sample_token": token,
                "translation": [float(x) for x in c],
                # nusc size order is [w, l, h]; our dims are [l, w, h]
                "size": [float(b[4]), float(b[3]), float(b[5])],
                "rotation": _yaw_quaternion(float(b[6]) + dyaw),
                "velocity": [float(v3[0]), float(v3[1])],
                "detection_name": name,
                "detection_score": float(scores[i]),
                "attribute_name": attr,
            })
        results[token] = annos

    out = {
        "results": results,
        "meta": meta or {"use_camera": False, "use_lidar": True,
                         "use_radar": False, "use_map": False,
                         "use_external": False},
    }
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(out, f)
    return out_path
