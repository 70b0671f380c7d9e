"""Waymo detection prediction writer, a ``metrics_pb2.Objects`` file (own
copy of lidarseg3d_tpu/datasets/waymo/det_submission.py). The boxes stay
in Waymo's native layout [x, y, z, length, width, height, heading] through
the whole pipeline, so predictions are written as they are. Needs
waymo_open_dataset, which it imports at the call (ImportError without
it, as in the JAX package).
"""

import os
import os.path as osp

import numpy as np

# detection class id (0-based, VEHICLE/PEDESTRIAN/CYCLIST order) -> proto type
_LABEL_TO_TYPE = {0: 1, 1: 2, 2: 4}


def write_detection_objects(detections, output_dir,
                            filename="waymo_det_predictions.bin"):
    """detections: {token: {box3d_lidar [N, 7], scores [N], label_preds [N],
    valid [N] (optional)}} with token = '<context_name>_<timestamp>'."""
    from waymo_open_dataset import label_pb2
    from waymo_open_dataset.protos import metrics_pb2

    objects = metrics_pb2.Objects()
    for token, det in detections.items():
        context_name, ts = token.rsplit("_", 1)
        boxes = np.asarray(det["box3d_lidar"], np.float64).reshape(-1, 7)
        scores = np.asarray(det["scores"], np.float64).reshape(-1)
        labels = np.asarray(det["label_preds"], np.int64).reshape(-1)
        valid = np.asarray(
            det.get("valid", np.ones(len(boxes), bool))).reshape(-1)
        # tracking submissions additionally carry per-box track ids
        # (reference _create_pd_detection(..., tracking=True))
        tids = det.get("tracking_ids")
        for i, (b, s, lab, ok) in enumerate(zip(boxes, scores, labels,
                                                valid)):
            if not ok:
                continue
            o = objects.objects.add()
            o.context_name = context_name
            o.frame_timestamp_micros = int(ts)
            box = label_pb2.Label.Box()
            box.center_x, box.center_y, box.center_z = b[0], b[1], b[2]
            box.length, box.width, box.height = b[3], b[4], b[5]
            box.heading = b[6]
            o.object.box.CopyFrom(box)
            o.score = float(s)
            o.object.type = _LABEL_TO_TYPE.get(int(lab), 0)
            if tids is not None:
                o.object.id = str(int(tids[i]))
    out = osp.join(output_dir or ".", filename)
    os.makedirs(osp.dirname(osp.abspath(out)), exist_ok=True)
    with open(out, "wb") as f:
        f.write(objects.SerializeToString())
    return out
