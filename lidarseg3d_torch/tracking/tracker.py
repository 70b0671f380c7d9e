"""Constant-velocity BEV multi-object tracker, CenterPoint's "tracking by
velocity" (own copy of lidarseg3d_tpu/tracking/tracker.py; host numpy,
scipy for the Hungarian matcher).

One class serves both of the reference's trackers: the nuScenes one
(per-class distance gates, greedy or Hungarian matching, every unmatched
detection born) and the Waymo one (births above a score threshold,
greedy matching). Each detection carries a BEV velocity and is moved back
by ``-velocity * time_lag`` onto the previous frame, matched to the live
tracks by gated nearest centre, and a track left unmatched coasts (its
centre advanced by its last motion) for up to ``max_age`` frames, kept
for matching but flagged inactive so that the tools leave it out of
their output.
"""

import numpy as np

INVALID = 1e18


def greedy_assignment(dist):
    """Row-greedy matching: each detection (row) takes its nearest track
    (column) still free if the gated cost is finite -> [M, 2] int32 of
    (detection, track)."""
    matches = []
    if dist.shape[1] == 0:
        return np.zeros((0, 2), np.int32)
    dist = dist.copy()
    for i in range(dist.shape[0]):
        j = int(dist[i].argmin())
        if dist[i, j] < INVALID / 100:
            dist[:, j] = INVALID
            matches.append((i, j))
    return np.asarray(matches, np.int32).reshape(-1, 2)


def hungarian_assignment(dist):
    """The optimal assignment (scipy), gated-out pairs removed from it."""
    from scipy.optimize import linear_sum_assignment

    cost = np.minimum(dist, INVALID)
    rows, cols = linear_sum_assignment(cost)
    keep = cost[rows, cols] < INVALID / 100
    return np.stack([rows[keep], cols[keep]], axis=-1).astype(np.int32)


class CenterTracker:
    """Args:
        class_names: the tracked classes; detections of others are dropped.
        max_dist: {class name: gate in metres}.
        max_age: frames a lost track coasts before it is deleted.
        score_thresh: the least score that gives birth to a track (None:
            every unmatched detection does).
        hungarian: optimal instead of greedy matching.

    ``step`` takes a list of dicts with at least ``translation`` [>= 2]
    (global), ``velocity`` [2] (global BEV m/s), ``detection_name`` and
    ``score`` (other keys pass through) and returns the frame's tracks:
    the input dicts with ``tracking_id`` (1-based), ``active`` (0 while
    coasting) and ``age``."""

    def __init__(self, class_names, max_dist, max_age=3, score_thresh=None,
                 hungarian=False):
        self.class_names = list(class_names)
        self.max_dist = dict(max_dist)
        self.max_age = max_age
        self.score_thresh = score_thresh
        self.hungarian = hungarian
        self.reset()

    def reset(self):
        self.id_count = 0
        self.tracks = []

    def step(self, detections, time_lag):
        """Advance one frame; ``time_lag``: seconds since the previous frame
        (0 on a sequence's first frame after ``reset()``)."""
        dets = []
        for d in detections:
            name = d["detection_name"]
            if name not in self.class_names:
                continue
            d = dict(d)
            d["ct"] = np.asarray(d["translation"][:2], np.float32)
            # moved back to the previous frame's time (constant velocity)
            d["motion"] = -np.asarray(d["velocity"][:2],
                                      np.float32) * time_lag
            d["cls_id"] = self.class_names.index(name)
            dets.append(d)
        if not dets:
            self.tracks = []
            return []

        N, M = len(dets), len(self.tracks)
        det_ct = np.stack([d["ct"] + d["motion"] for d in dets])
        det_cls = np.asarray([d["cls_id"] for d in dets], np.int32)
        gates = np.asarray([self.max_dist[d["detection_name"]]
                            for d in dets], np.float32)
        if M:
            trk_ct = np.stack([t["ct"] for t in self.tracks])
            trk_cls = np.asarray([t["cls_id"] for t in self.tracks],
                                 np.int32)
            dist = np.linalg.norm(det_ct[:, None, :] - trk_ct[None, :, :],
                                  axis=-1)
            bad = (dist > gates[:, None]) | (det_cls[:, None]
                                             != trk_cls[None, :])
            dist = np.where(bad, INVALID, dist)
            assign = (hungarian_assignment if self.hungarian
                      else greedy_assignment)
            matches = assign(dist)
        else:
            matches = np.zeros((0, 2), np.int32)
        matched_dets = set(int(m) for m in matches[:, 0])
        matched_trks = set(int(m) for m in matches[:, 1])

        out = []
        for di, ti in matches:
            t = dets[di]
            prev = self.tracks[ti]
            t["tracking_id"] = prev["tracking_id"]
            t["age"] = 1
            t["active"] = prev["active"] + 1
            out.append(t)
        for di in range(N):
            if di in matched_dets:
                continue
            t = dets[di]
            if (self.score_thresh is not None
                    and t["score"] <= self.score_thresh):
                continue
            self.id_count += 1
            t["tracking_id"] = self.id_count
            t["age"] = 1
            t["active"] = 1
            out.append(t)
        for ti in range(M):
            if ti in matched_trks:
                continue
            t = self.tracks[ti]
            if t["age"] < self.max_age:
                t["age"] += 1
                t["active"] = 0
                t["ct"] = t["ct"] - t["motion"]  # coast on the last motion
                out.append(t)
        self.tracks = out
        return out


# the reference's gate tables (pub_tracker.py, waymo_tracking/test.py)
NUSC_TRACKING_NAMES = (
    "bicycle", "bus", "car", "motorcycle", "pedestrian", "trailer", "truck",
)
NUSC_CLS_VELOCITY_ERROR = {
    "car": 4, "truck": 4, "bus": 5.5, "trailer": 3, "pedestrian": 1,
    "motorcycle": 13, "bicycle": 3,
}
WAYMO_TRACKING_NAMES = ("VEHICLE", "PEDESTRIAN", "CYCLIST")
