"""nuScenes tracking from detection results (the port's counterpart of
tools/nusc_tracking.py; no devkit).

    python -m lidarseg3d_torch.tools.nusc_tracking --checkpoint RESULTS.json
        --info_path infos_val_NNsweeps_segdet.pkl --work_dir OUT
        [--max_age 3] [--hungarian]

Reads a detection result JSON in the official nuScenes format
(``{"results": {sample_token: [box dicts]}}``, as ``tools.test`` writes
``nusc_det_results.json``) and each frame's ``token``, ``timestamp``,
``scene_name`` and ``first`` from the info pkl, runs
``tracking.CenterTracker`` with the nuScenes gates scene by scene, and
writes ``OUT/tracking_result.json`` in the official tracking format
(coasting tracks left out), for the devkit's TrackingEval.
"""

import argparse
import json
import os
import pickle
import time

from ..tracking.tracker import (NUSC_CLS_VELOCITY_ERROR,
                                NUSC_TRACKING_NAMES, CenterTracker)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="nuScenes tracking")
    p.add_argument("--work_dir", required=True)
    p.add_argument("--checkpoint", required=True,
                   help="detection result json (nuScenes detection format)")
    p.add_argument("--info_path", required=True,
                   help="val / test info pkl (tools.create_data)")
    p.add_argument("--hungarian", action="store_true")
    p.add_argument("--max_age", type=int, default=3)
    return p.parse_args(argv)


def load_frames(info_path):
    """Info pkl -> the frames in order, [{token, timestamp, first}]."""
    with open(info_path, "rb") as f:
        infos = pickle.load(f)
    frames = []
    prev_scene = object()
    for info in infos:
        scene = info.get("scene_name", None)
        first = info.get("first", scene != prev_scene)
        prev_scene = scene
        frames.append(dict(token=info["token"],
                           timestamp=float(info["timestamp"]),
                           first=bool(first)))
    return frames


def run_tracking(predictions, frames, max_age=3, hungarian=False):
    """-> {sample_token: [tracking box dicts]} over ``frames``."""
    tracker = CenterTracker(NUSC_TRACKING_NAMES, NUSC_CLS_VELOCITY_ERROR,
                            max_age=max_age, hungarian=hungarian)
    results = {}
    last_ts = 0.0
    for fr in frames:
        token = fr["token"]
        if fr["first"]:
            tracker.reset()
            last_ts = fr["timestamp"]
        time_lag = fr["timestamp"] - last_ts
        last_ts = fr["timestamp"]
        dets = []
        for d in predictions.get(token, []):
            d = dict(d)
            d["score"] = d.get("detection_score", 1.0)
            dets.append(d)
        annos = []
        for item in tracker.step(dets, time_lag):
            if item["active"] == 0:
                continue  # coasting tracks are kept but not reported
            annos.append({
                "sample_token": token,
                "translation": list(map(float, item["translation"])),
                "size": list(map(float, item["size"])),
                "rotation": list(map(float, item["rotation"])),
                "velocity": list(map(float, item["velocity"][:2])),
                "tracking_id": str(item["tracking_id"]),
                "tracking_name": item["detection_name"],
                "tracking_score": float(item["score"]),
            })
        results[token] = annos
    return results


def main(argv=None):
    """-> the path of the tracking JSON written."""
    args = parse_args(argv)
    with open(args.checkpoint) as f:
        predictions = json.load(f)["results"]
    frames = load_frames(args.info_path)
    print(f"tracking {len(frames)} frames")
    t0 = time.time()
    results = run_tracking(predictions, frames, args.max_age,
                           args.hungarian)
    print(f"{len(frames) / max(time.time() - t0, 1e-9):.1f} FPS")
    os.makedirs(args.work_dir, exist_ok=True)
    out = {"results": results,
           "meta": {"use_camera": False, "use_lidar": True,
                    "use_radar": False, "use_map": False,
                    "use_external": False}}
    path = os.path.join(args.work_dir, "tracking_result.json")
    with open(path, "w") as f:
        json.dump(out, f)
    print(f"wrote {path}")
    return path


if __name__ == "__main__":
    main()
