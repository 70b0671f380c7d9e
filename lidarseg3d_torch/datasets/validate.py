"""Fail-fast validation of an externally mounted raw dataset tree (own
copy of lidarseg3d_tpu/datasets/validate.py).

``python -m lidarseg3d_torch.tools.create_data <dataset> --root R
--dry-data`` runs these checks and writes nothing, so a mis-mounted tree
fails in seconds, not in the middle of a conversion or a training run.

Checks per dataset:
- semantickitti: ``<root>/<seq>/velodyne/*.bin`` float32 x,y,z,r rows
  (size % 16 == 0); ``labels/*.label`` uint32, one per point, lower 16
  bits in LEARNING_MAP; camera frames (``image_2/`` + ``calib.txt`` with
  P2/Tr) when ``use_img``.
- semanticnusc: ``<root>/<version>/*.json`` devkit tables present;
  ``lidarseg/<version>/*_lidarseg.bin`` uint8 labels, one per point of
  the matching ``samples/LIDAR_TOP/*.pcd.bin`` scan (float32 5-column
  rows, size % 20 == 0); raw category ids < 32.
- semanticwaymo: ``<root>/<split>/*.tfrecord`` segments present and
  non-empty (the converter's input, waymo/converter.py); where the split
  was converted into ``<root>`` (``infos_<split>_*sweeps_segdet.pkl``),
  its frame pkls carry the detection boxes (``gt_boxes`` [N, 7],
  ``gt_names``, ``gt_num_points`` in ``annotations``).

Each function raises DataTreeError with an actionable message at the
first hard failure and returns a summary dict on success.
"""

import os
import os.path as osp

import numpy as np


class DataTreeError(RuntimeError):
    """A mounted dataset tree does not match the expected layout."""


def _fail(msg):
    raise DataTreeError(msg)


def _sample(names, k):
    if len(names) <= k:
        return list(names)
    idx = np.linspace(0, len(names) - 1, k).astype(int)
    return [names[i] for i in idx]


def validate_semantickitti(root, sequences=None, max_frames=8,
                           use_img=False, require_labels=True):
    if not osp.isdir(root):
        _fail(f"semantickitti root {root!r} is not a directory")
    if sequences is None:
        sequences = sorted(
            d for d in os.listdir(root)
            if osp.isdir(osp.join(root, d, "velodyne")))
    if not sequences:
        _fail(f"no '<seq>/velodyne' directories under {root!r} — expected "
              "the semantic-kitti layout root/<seq>/velodyne/*.bin")
    from .semantickitti import metadata as meta

    valid_raw = set(meta.LEARNING_MAP)
    n_frames = 0
    for seq in sequences:
        vdir = osp.join(root, seq, "velodyne")
        names = sorted(os.listdir(vdir))
        if not names:
            _fail(f"{vdir!r} is empty")
        n_frames += len(names)
        ldir = osp.join(root, seq, "labels")
        has_labels = osp.isdir(ldir)
        if require_labels and not has_labels:
            _fail(f"{ldir!r} missing — pass require_labels=False for the "
                  "test split")
        n_nonzero_sem = 0
        for name in _sample(names, max_frames):
            bpath = osp.join(vdir, name)
            size = osp.getsize(bpath)
            if size == 0 or size % 16 != 0:
                _fail(f"{bpath!r}: size {size} not a positive multiple of "
                      "16 (expected float32 [n,4] x,y,z,r rows)")
            npts = size // 16
            if has_labels:
                lpath = osp.join(ldir, name.replace(".bin", ".label"))
                if not osp.isfile(lpath):
                    _fail(f"label file {lpath!r} missing for {bpath!r}")
                raw = np.fromfile(lpath, dtype=np.uint32)
                if len(raw) != npts:
                    _fail(f"{lpath!r}: {len(raw)} labels != {npts} points "
                          "(every point needs a label; loading.py reads "
                          "uint32 and remaps raw & 0xFFFF)")
                sem = raw & np.uint32(0xFFFF)
                n_nonzero_sem += int(np.count_nonzero(sem))
                uniq = np.unique(sem)
                unknown = sorted(int(s) for s in uniq
                                 if int(s) not in valid_raw)
                if unknown:
                    _fail(f"{lpath!r}: raw semantic ids {unknown[:8]} not in "
                          "LEARNING_MAP — wrong label bit-layout? (semantic "
                          "id lives in the LOWER 16 bits, instance id in "
                          "the upper)")
        if has_labels and n_nonzero_sem == 0:
            _fail(f"every sampled label in {ldir!r} decodes to raw id 0 "
                  "('unlabeled') in the lower 16 bits — wrong label "
                  "bit-layout? (semantic id lives in the LOWER 16 bits, "
                  "instance id in the upper)")
        if use_img:
            idir = osp.join(root, seq, "image_2")
            if not osp.isdir(idir) or not os.listdir(idir):
                _fail(f"{idir!r} missing/empty but use_img requested")
            cpath = osp.join(root, seq, "calib.txt")
            if not osp.isfile(cpath):
                _fail(f"{cpath!r} missing but use_img requested")
            with open(cpath) as f:
                keys = {ln.split(":")[0].strip() for ln in f if ":" in ln}
            for k in ("P2", "Tr"):
                if k not in keys:
                    _fail(f"{cpath!r}: no '{k}:' row (needed for the "
                          "P2·Tr frustum projection, loading.py)")
    return {"dataset": "semantickitti", "sequences": len(sequences),
            "frames": n_frames}


def validate_semanticnusc(root, version="v1.0-trainval", max_frames=8):
    if not osp.isdir(root):
        _fail(f"semanticnusc root {root!r} is not a directory")
    vdir = osp.join(root, version)
    if not osp.isdir(vdir):
        _fail(f"{vdir!r} missing — expected the devkit table dir "
              f"<root>/{version}/*.json")
    from .nuscenes.common import NuScenesTables

    for t in NuScenesTables.TABLES:
        if t == "lidarseg" and version.endswith("test"):
            continue
        p = osp.join(vdir, f"{t}.json")
        if not osp.isfile(p):
            _fail(f"table {p!r} missing")
    import json

    with open(osp.join(vdir, "lidarseg.json")) as f:
        lidarseg = json.load(f)
    if not lidarseg:
        _fail(f"{vdir}/lidarseg.json is empty")
    with open(osp.join(vdir, "sample_data.json")) as f:
        sample_data = json.load(f)
    sd_by_token = {r["token"]: r for r in sample_data}
    checked = 0
    for rec in _sample(lidarseg, max_frames):
        lpath = osp.join(root, rec["filename"])
        if not osp.isfile(lpath):
            _fail(f"lidarseg label {lpath!r} missing (lidarseg.json "
                  "filename fields are relative to the dataset root)")
        labels = np.fromfile(lpath, dtype=np.uint8)
        sd = sd_by_token.get(rec["sample_data_token"])
        if sd is None:
            _fail(f"lidarseg record {rec['token']} points at unknown "
                  f"sample_data {rec['sample_data_token']}")
        ppath = osp.join(root, sd["filename"])
        if not osp.isfile(ppath):
            _fail(f"LIDAR_TOP scan {ppath!r} missing")
        size = osp.getsize(ppath)
        if size % 20 != 0:
            _fail(f"{ppath!r}: size {size} not a multiple of 20 (expected "
                  "float32 [n,5] x,y,z,i,ring rows)")
        npts = size // 20
        if len(labels) != npts:
            _fail(f"{lpath!r}: {len(labels)} uint8 labels != {npts} points "
                  f"in {ppath!r} — wrong dtype or truncated file?")
        if labels.max(initial=0) > 31:
            _fail(f"{lpath!r}: raw category id {int(labels.max())} > 31 "
                  "(nuScenes-lidarseg uses uint8 general ids 0..31)")
        checked += 1
    return {"dataset": "semanticnusc", "version": version,
            "lidarseg_records": len(lidarseg), "checked": checked}


def validate_semanticwaymo(root, split="training", max_frames=8):
    sdir = osp.join(root, split)
    if not osp.isdir(sdir):
        _fail(f"{sdir!r} missing — expected <root>/{split}/*.tfrecord "
              "(converter input, waymo/converter.py)")
    recs = [f for f in os.listdir(sdir) if "tfrecord" in f]
    if not recs:
        _fail(f"no *.tfrecord files under {sdir!r}")
    empty = [f for f in recs if osp.getsize(osp.join(sdir, f)) == 0]
    if empty:
        _fail(f"empty tfrecords under {sdir!r}: {empty[:4]}")
    rep = {"dataset": "semanticwaymo", "split": split,
           "tfrecords": len(recs)}
    infos = sorted(f for f in os.listdir(root)
                   if f.startswith(f"infos_{split}_")
                   and f.endswith("sweeps_segdet.pkl"))
    if infos:
        rep.update(_check_waymo_frames(root, infos, max_frames))
    return rep


def _check_waymo_frames(root, infos, max_frames):
    """Read up to ``max_frames`` frame pkls of each converted info file:
    each must carry one gt box, name and point count per label (a
    converter that drops the labels leaves them out, and every detection
    config would then train on empty targets)."""
    import pickle

    n_frames = n_boxes = 0
    for name in infos:
        with open(osp.join(root, name), "rb") as f:
            paths = [i["path"] for i in pickle.load(f)]
        for path in _sample(paths, max_frames):
            with open(path, "rb") as f:
                ann = pickle.load(f).get("annotations", {})
            missing = [k for k in ("gt_boxes", "gt_names", "gt_num_points")
                       if k not in ann]
            if missing:
                _fail(f"frame {path!r} has no {missing} in its annotations "
                      "— converted without the box labels; convert the "
                      "split again (waymo/converter.py)")
            n = len(ann["gt_boxes"])
            if (np.shape(ann["gt_boxes"]) != (n, 7)
                    or len(ann["gt_names"]) != n
                    or len(ann["gt_num_points"]) != n):
                _fail(f"frame {path!r}: gt_boxes {np.shape(ann['gt_boxes'])}"
                      f", {len(ann['gt_names'])} gt_names and "
                      f"{len(ann['gt_num_points'])} gt_num_points")
            n_frames += 1
            n_boxes += n
    return {"converted_frames": n_frames, "gt_boxes": n_boxes}
