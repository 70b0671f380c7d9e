"""Waymo tracking from detection predictions (the port's counterpart of
tools/waymo_tracking.py).

    python -m lidarseg3d_torch.tools.waymo_tracking
        --checkpoint det_predictions.pkl --info_path infos_val_01sweeps_segdet.pkl
        --work_dir OUT [--max_age 3] [--vehicle 0.8] [--pedestrian 0.4]
        [--cyclist 0.6] [--score_thresh 0.75] [--sweep CLASS=v1,v2,...]

Reads the prediction pkl ``tools.test`` writes ({token: {box3d_lidar,
scores, label_preds, valid[, velocity]}}), moves each frame's boxes into
the global frame with the frame pkl's vehicle pose (``veh_to_global``,
datasets/waymo/converter.py), runs ``tracking.CenterTracker`` context by
context in time order, and writes the tracks as a metrics_pb2 Objects
file (``OUT/tracking_pred.bin``, for the official
compute_tracking_metrics_main), which needs waymo_open_dataset as the
JAX tool's does (ImportError without it). ``--sweep`` is the gate line
search: one file per value of one class's gate. Boxes keep the native
Waymo layout (x, y, z, length, width, height, heading) throughout.
"""

import argparse
import os
import pickle

import numpy as np

from ..tracking.tracker import WAYMO_TRACKING_NAMES, CenterTracker


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Waymo tracking")
    p.add_argument("--work_dir", required=True)
    p.add_argument("--checkpoint", required=True,
                   help="detection prediction pkl from tools.test")
    p.add_argument("--info_path", required=True)
    p.add_argument("--max_age", type=int, default=3)
    p.add_argument("--vehicle", type=float, default=0.8)
    p.add_argument("--pedestrian", type=float, default=0.4)
    p.add_argument("--cyclist", type=float, default=0.6)
    p.add_argument("--score_thresh", type=float, default=0.75)
    p.add_argument("--sweep", default=None,
                   help="gate line search, e.g. 'VEHICLE=0.5,0.8,1.1': one "
                        "tracking file per value")
    return p.parse_args(argv)


def boxes_to_global(boxes, velocity, pose):
    """[N, 7] boxes and [N, 2] BEV velocities in the vehicle frame -> the
    global frame under ``pose`` (4x4, vehicle -> global)."""
    R, t = pose[:3, :3], pose[:3, 3]
    out = boxes.copy()
    out[:, :3] = boxes[:, :3] @ R.T + t
    out[:, 6] = boxes[:, 6] + np.arctan2(pose[1, 0], pose[0, 0])
    vel3 = np.concatenate(
        [velocity, np.zeros((len(velocity), 1), velocity.dtype)], axis=-1)
    return out, (vel3 @ R.T)[:, :2]


def load_pose_ts(info, info_dir):
    """(pose, timestamp) of an info row: the info's own fields, else its
    frame pkl's (a relative path read under ``info_dir``)."""
    if "veh_to_global" in info and "timestamp" in info:
        return (np.asarray(info["veh_to_global"], np.float64).reshape(4, 4),
                float(info["timestamp"]))
    path = info["path"]
    if not os.path.isabs(path) and not os.path.exists(path):
        path = os.path.join(info_dir, path)
    with open(path, "rb") as f:
        fr = pickle.load(f)
    return (np.asarray(fr["veh_to_global"], np.float64).reshape(4, 4),
            float(fr["timestamp"]))


def track(predictions, infos, max_dist, max_age=3, score_thresh=0.75,
          info_dir="."):
    """Track every predicted frame of ``infos`` -> {token: {tracking_ids,
    box3d_lidar, label_preds, scores (the active tracks' vehicle-frame
    boxes), global_box3d, global_velocity (every box of the frame in the
    global frame)}}."""
    frames = []
    for info in infos:
        token = info["token"]
        if token not in predictions:
            continue
        pose, ts = load_pose_ts(info, info_dir)
        frames.append(dict(token=token, timestamp=ts, pose=pose,
                           context=info.get("context",
                                            token.rsplit("_", 1)[0])))
    frames.sort(key=lambda f: (f["context"], f["timestamp"]))

    tracker = CenterTracker(WAYMO_TRACKING_NAMES, max_dist, max_age=max_age,
                            score_thresh=score_thresh)
    results = {}
    prev_ctx, last_ts = None, 0.0
    for fr in frames:
        token = fr["token"]
        det = predictions[token]
        if fr["context"] != prev_ctx:
            tracker.reset()
            last_ts = fr["timestamp"]
        prev_ctx = fr["context"]
        time_lag = fr["timestamp"] - last_ts
        last_ts = fr["timestamp"]
        boxes = np.asarray(det["box3d_lidar"], np.float64).reshape(-1, 7)
        scores = np.asarray(det["scores"], np.float64).reshape(-1)
        labels = np.asarray(det["label_preds"], np.int64).reshape(-1)
        valid = np.asarray(det.get("valid", np.ones(len(boxes), bool)),
                           bool).reshape(-1)
        vel = np.asarray(det.get("velocity", np.zeros((len(boxes), 2))),
                         np.float64).reshape(-1, 2)
        gboxes, gvel = boxes_to_global(boxes, vel, fr["pose"])
        dets = []
        for i in range(len(gboxes)):
            if not valid[i] or int(labels[i]) >= len(WAYMO_TRACKING_NAMES):
                continue
            dets.append(dict(translation=gboxes[i, :3], velocity=gvel[i],
                             detection_name=WAYMO_TRACKING_NAMES[
                                 int(labels[i])],
                             score=float(scores[i]), box_id=i))
        keep = [t for t in tracker.step(dets, time_lag) if t["active"] != 0]
        idx = np.asarray([t["box_id"] for t in keep], np.int64)
        results[token] = {
            "tracking_ids": np.asarray([t["tracking_id"] for t in keep],
                                       np.int64),
            "box3d_lidar": boxes[idx], "label_preds": labels[idx],
            "scores": scores[idx], "global_box3d": gboxes,
            "global_velocity": gvel}
    return results


def run_once(args, max_dist, filename):
    """Track and write one Objects file (needs waymo_open_dataset)."""
    from ..datasets.waymo.det_submission import write_detection_objects

    with open(args.checkpoint, "rb") as f:
        predictions = pickle.load(f)
    with open(args.info_path, "rb") as f:
        infos = pickle.load(f)
    results = track(predictions, infos, max_dist, args.max_age,
                    args.score_thresh,
                    os.path.dirname(os.path.abspath(args.info_path)))
    os.makedirs(args.work_dir, exist_ok=True)
    path = write_detection_objects(results, args.work_dir,
                                   filename=filename)
    print(f"wrote {path}; evaluate with the official waymo-open-dataset "
          "compute_tracking_metrics_main against gt.bin")
    return path


def main(argv=None):
    args = parse_args(argv)
    max_dist = {"VEHICLE": args.vehicle, "PEDESTRIAN": args.pedestrian,
                "CYCLIST": args.cyclist}
    if not args.sweep:
        return [run_once(args, max_dist, "tracking_pred.bin")]
    # the gate line search: one submission per value, scored outside
    cls, values = args.sweep.split("=")
    out = []
    for v in values.split(","):
        out.append(run_once(args, dict(max_dist, **{cls: float(v)}),
                            f"tracking_pred_{cls}_{v}.bin"))
    return out


if __name__ == "__main__":
    main()
