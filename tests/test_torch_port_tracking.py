"""Tracking in the port against the JAX package's, exactly:

- ``tracking.CenterTracker``, greedy and Hungarian, with and without a
  birth threshold, over a seeded 6-frame sequence with births, coasting,
  deaths, class and distance gates and two detections competing for one
  track: per frame every track's tracking_id, age, active flag and centre
  equal JAX's;
- ``tools.nusc_tracking`` on the detection JSON the port's writer makes
  of a seeded two-scene nuScenes tree's moving boxes
  (``detections_to_nusc_json``, as ``tools.test`` writes it), with the
  infos' scene_name / first / timestamp: its tracking JSON equals the JAX
  tool's, greedy and Hungarian;
- ``tools.waymo_tracking`` on a seeded prediction pkl over a seeded Waymo
  tree whose frames carry moving vehicle poses: every frame's global
  boxes and velocities equal JAX's ``boxes_to_global`` and its tracks
  (ids, boxes, labels, scores) equal those the JAX tool hands its
  metrics_pb2 writer; the port's writer, like JAX's, needs
  waymo_open_dataset."""

import importlib.util
import json
import os
import pickle

import numpy as np
import pytest

from lidarseg3d_tpu.tracking import tracker as jtracker
from lidarseg3d_torch import synthetic
from lidarseg3d_torch.datasets.nuscenes.common import create_nuscenes_seg_infos
from lidarseg3d_torch.datasets.nuscenes.det_submission import (
    NUSC_DET_NAMES, detections_to_nusc_json)
from lidarseg3d_torch.tools import nusc_tracking, waymo_tracking
from lidarseg3d_torch.tracking import tracker as ttracker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GATES = {"VEHICLE": 1.5, "PEDESTRIAN": 0.6, "CYCLIST": 1.0}


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sequence(seed=0):
    """Six frames of detections 0.1 s apart: five objects moving at their
    own velocities (one born at frame 2, one gone after frame 2, one
    jumping past its gate at frame 4), a cyclist riding next to a vehicle
    (the class gate), a second vehicle detection next to the first (two
    candidates for one track) and low-score detections."""
    rng = np.random.default_rng(seed)
    names = ["VEHICLE", "VEHICLE", "PEDESTRIAN", "CYCLIST", "VEHICLE"]
    start = rng.uniform(-20, 20, (5, 2))
    vel = rng.uniform(-5, 5, (5, 2))
    frames = []
    for f in range(6):
        dets = []
        for k in range(5):
            if (k == 1 and f < 2) or (k == 2 and f > 2):
                continue
            ct = start[k] + vel[k] * 0.1 * f + rng.normal(0, 0.05, 2)
            if k == 3 and f >= 4:
                ct = ct + 5.0  # past its gate: a new track
            dets.append(dict(translation=[*ct, 0.5], velocity=vel[k]
                             + rng.normal(0, 0.1, 2), detection_name=names[k],
                             score=float(rng.uniform(0.3, 1.0)), k=k))
        dets.append(dict(dets[0], detection_name="CYCLIST", score=0.9))
        dets.append(dict(dets[0], translation=[
            dets[0]["translation"][0] + 0.4, dets[0]["translation"][1],
            0.5], score=0.8))
        dets.append(dict(translation=[*rng.uniform(-20, 20, 2), 0.0],
                         velocity=[0.0, 0.0], detection_name="PEDESTRIAN",
                         score=float(rng.uniform(0.0, 0.4))))
        frames.append(dets)
    return frames


@pytest.mark.parametrize("hungarian", [False, True])
@pytest.mark.parametrize("score_thresh", [None, 0.5])
def test_center_tracker_matches_jax(hungarian, score_thresh):
    kw = dict(max_age=2, score_thresh=score_thresh, hungarian=hungarian)
    trackers = [m.CenterTracker(m.WAYMO_TRACKING_NAMES, GATES, **kw)
                for m in (jtracker, ttracker)]
    seen = set()
    for f, dets in enumerate(_sequence()):
        outs = [tr.step([dict(d) for d in dets], 0.1 if f else 0.0)
                for tr in trackers]
        rows = [[(o["tracking_id"], o["age"], o["active"],
                  o["ct"].tobytes()) for o in out] for out in outs]
        assert rows[0] == rows[1], f
        seen |= {(o["active"], o["age"]) for o in outs[1]}
    # matched, born and coasting tracks all occurred
    assert {a for a, _ in seen} >= {0, 1, 2} and {g for _, g in seen} >= {
        1, 2}
    assert trackers[1].id_count == trackers[0].id_count > 5


@pytest.fixture(scope="module")
def nusc(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("nusc_tracking"))
    synthetic.write_semnusc_tree(root, scenes=("scene-0003", "scene-0012"),
                                 samples=4, points=(300, 400),
                                 max_range=12.0, cams=(), boxes=10, seed=3)
    create_nuscenes_seg_infos(root, cam_chans=())
    info_path = os.path.join(root, "infos_val_01sweeps_segdet.pkl")
    with open(info_path, "rb") as f:
        infos = pickle.load(f)
    rng = np.random.default_rng(4)
    dets = {}
    for info in infos:
        gt = info["gt_boxes"]
        labels = np.asarray([NUSC_DET_NAMES.index(x)
                             for x in info["gt_names"]])
        dets[info["token"]] = dict(
            box3d_lidar=gt[:, :7] + rng.normal(0, 0.05, (len(gt), 7)),
            velocity=gt[:, 7:9], label_preds=labels,
            scores=rng.uniform(0.2, 1.0, len(gt)),
            valid=rng.uniform(size=len(gt)) < 0.9)
    path = detections_to_nusc_json(
        dets, {i["token"]: i for i in infos},
        os.path.join(root, "nusc_det_results.json"))
    return dict(json=path, info=info_path, n=len(infos))


@pytest.mark.parametrize("hungarian", [False, True])
def test_nusc_tracking_json_matches_jax_tool(nusc, tmp_path, monkeypatch,
                                             hungarian):
    extra = ["--hungarian"] if hungarian else []
    args = ["--checkpoint", nusc["json"], "--info_path", nusc["info"]]
    got = nusc_tracking.main(args + ["--work_dir", str(tmp_path / "t")]
                             + extra)
    jtool = _jax_tool("nusc_tracking")
    monkeypatch.setattr("sys.argv", ["nusc_tracking.py", *args,
                                     "--work_dir", str(tmp_path / "j"),
                                     *extra])
    jtool.main()
    with open(got) as f:
        mine = json.load(f)
    with open(tmp_path / "j" / "tracking_result.json") as f:
        want = json.load(f)
    assert mine == want
    assert len(mine["results"]) == nusc["n"]
    ids = [a["tracking_id"] for r in mine["results"].values() for a in r]
    assert len(ids) > len(set(ids)) > 1  # tracks continue across frames


def _waymo_predictions(infos, seed=5):
    """Twelve objects moving in the global frame, seen from each frame's
    vehicle pose with noise; a SIGN now and then, some rows invalid."""
    rng = np.random.default_rng(seed)
    ctr = rng.uniform([1195, -350, 11], [1215, -330, 13], (12, 3))
    vel = rng.uniform(-6, 6, (12, 2))
    size = rng.uniform(0.8, 4.5, (12, 3))
    yaw = rng.uniform(-np.pi, np.pi, 12)
    labels = rng.integers(0, 4, 12)
    preds = {}
    for i, info in enumerate(infos):
        with open(info["path"], "rb") as f:
            pose = pickle.load(f)["veh_to_global"]
        g = np.concatenate([ctr[:, :2] + vel * 0.1 * i, ctr[:, 2:]], 1)
        local = (g - pose[:3, 3]) @ pose[:3, :3]
        rot = np.arctan2(pose[1, 0], pose[0, 0])
        boxes = np.concatenate([local, size, (yaw - rot)[:, None]], 1)
        preds[info["token"]] = dict(
            box3d_lidar=(boxes + rng.normal(0, 0.03, boxes.shape)).astype(
                np.float32),
            velocity=(np.concatenate([vel, np.zeros((12, 1))], 1)
                      @ pose[:3, :3])[:, :2].astype(np.float32),
            scores=rng.uniform(0.5, 1.0, 12).astype(np.float32),
            label_preds=labels, valid=rng.uniform(size=12) < 0.9)
    return preds


def test_waymo_tracking_matches_jax_tool(tmp_path, monkeypatch):
    root = str(tmp_path / "waymo")
    paths = synthetic.write_semanticwaymo_tree(
        root, splits=("val",), frames=6, top_cols=24, max_range=12.0,
        short_points=50, cams=(), seed=7)
    with open(paths["val"], "rb") as f:
        infos = pickle.load(f)
    preds = _waymo_predictions(infos)
    pkl = str(tmp_path / "det_predictions.pkl")
    with open(pkl, "wb") as f:
        pickle.dump(preds, f)
    got = waymo_tracking.track(preds, infos, GATES, max_age=3,
                               score_thresh=0.75)

    jtool = _jax_tool("waymo_tracking")
    captured = {}
    monkeypatch.setattr(
        "lidarseg3d_tpu.datasets.waymo.det_submission."
        "write_detection_objects",
        lambda res, out, filename: captured.setdefault("res", res))
    monkeypatch.setattr("sys.argv", [
        "waymo_tracking.py", "--checkpoint", pkl, "--info_path",
        paths["val"], "--work_dir", str(tmp_path / "j"), "--vehicle",
        str(GATES["VEHICLE"]), "--pedestrian", str(GATES["PEDESTRIAN"]),
        "--cyclist", str(GATES["CYCLIST"])])
    jtool.main()
    want = captured["res"]
    assert set(got) == set(want) and len(got) == 6
    poses = []
    for info in infos:
        pose, _ = jtool.load_pose_ts(info, None)
        poses.append(pose)
        det = preds[info["token"]]
        gb, gv = jtool.boxes_to_global(
            np.asarray(det["box3d_lidar"], np.float64),
            np.asarray(det["velocity"], np.float64), pose)
        g = got[info["token"]]
        np.testing.assert_array_equal(g["global_box3d"], gb)
        np.testing.assert_array_equal(g["global_velocity"], gv)
        w = want[info["token"]]
        for k in ("tracking_ids", "box3d_lidar", "label_preds", "scores"):
            np.testing.assert_array_equal(g[k], w[k], k)
    # the vehicle moves and turns away from the identity
    assert not np.allclose(poses[0], np.eye(4))
    assert not np.allclose(poses[0][:3, 3], poses[-1][:3, 3])
    ids = np.concatenate([g["tracking_ids"] for g in got.values()])
    assert len(ids) > len(set(ids.tolist())) > 1
    with pytest.raises(ImportError):  # the Objects writer's proto
        waymo_tracking.main(["--checkpoint", pkl, "--info_path",
                             paths["val"], "--work_dir", str(tmp_path / "t")])
