"""The port's detection host side and box geometry against the JAX
package's, on the same seeded numpy inputs:

- the Waymo converter's ``_decode_laser_labels`` on a frame of
  ``SimpleNamespace`` laser labels (an unknown type among them) equals
  JAX's, and the port's frame record carries it (the port's converter
  dropped the boxes before; ROADMAP §C); ``validate_semanticwaymo``
  (``create_data semanticwaymo --dry-data``) reads the converted frame
  pkls and refuses one without the boxes;
- the nuScenes detection points are CenterPoint's (x, y, z, intensity,
  time lag), held against the scans and sweeps read plainly from the
  tree, at 1 and 3 sweeps;
- box_np_ops (corners, points in boxes, BEV collision, the four global
  augmentations with their generator draws) and center_targets bit for
  bit;
- box_ops: the rotated BEV and 3D IoU within 1e-5, rotated and circle
  NMS selections equal (ties among the scores included), and the z
  rotation;
- det_metrics (Waymo AP / APH, nuScenes mAP, the grouping) within 1e-6;
- the nuScenes results JSON equal to JAX's, and the Waymo writer raising
  ImportError without waymo_open_dataset, as JAX's;
- the det pipeline, train (DBSampler over ``create_gt_database`` of a
  seeded Waymo tree with boxes, min_points, flips, rotation, scaling,
  translation, targets) and val, and the collate's det extras, bit for
  bit; ``create_data waymo_gt_database`` writes JAX's database.
"""

import os
import pickle
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from lidarseg3d_torch import synthetic

from test_torch_port_support import one_torch_thread  # noqa: F401


def _frame(seed):
    rng = np.random.default_rng(seed)
    labels = []
    for i in range(6):
        box = SimpleNamespace(**dict(zip(
            ("center_x", "center_y", "center_z", "length", "width",
             "height", "heading"), rng.uniform(-5, 5, 7).tolist())))
        labels.append(SimpleNamespace(box=box, type=[1, 2, 3, 4, 0, 9][i],
                                      num_lidar_points_in_box=int(
                                          rng.integers(0, 50))))
    pose = SimpleNamespace(transform=np.eye(4).reshape(-1).tolist())
    return SimpleNamespace(laser_labels=labels, pose=pose,
                           timestamp_micros=1_500_000_000_000_000)


def test_waymo_converter_keeps_the_box_labels():
    from lidarseg3d_tpu.datasets.waymo import converter as jc
    from lidarseg3d_torch.datasets.waymo import converter as tc

    frame = _frame(0)
    want, got = jc._decode_laser_labels(frame), tc._decode_laser_labels(frame)
    assert set(got) == set(want) == {"gt_boxes", "gt_names", "gt_num_points"}
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    assert list(got["gt_names"]) == ["VEHICLE", "PEDESTRIAN", "SIGN",
                                     "CYCLIST", "UNKNOWN", "UNKNOWN"]
    # the frame record carries them beside the segmentation labels
    pts = np.zeros((10, 5), np.float32)
    rec = tc.frame_record(frame, pts, np.zeros((10, 3), np.float32),
                          np.zeros(10, np.uint8), 8,
                          tc.top_slices_of([0, 5], [4, 4]), {})
    for k in want:
        np.testing.assert_array_equal(rec["annotations"][k], want[k])
    assert rec["annotations"]["num_seg_points"] == 8


def test_validate_reads_the_converted_boxes(tmp_path):
    from lidarseg3d_torch.datasets.validate import DataTreeError
    from lidarseg3d_torch.tools import create_data

    root = str(tmp_path)
    info = synthetic.write_semanticwaymo_tree(
        root, splits=("training",), frames=3, top_cols=8, max_range=12.0,
        short_points=50, cams=(), boxes=4)["training"]
    os.makedirs(os.path.join(root, "training"))
    with open(os.path.join(root, "training", "s.tfrecord"), "wb") as f:
        f.write(b"\0" * 8)
    argv = ["semanticwaymo", "--root", root, "--dry-data"]
    rep = create_data.main(argv)
    assert rep["tfrecords"] == 1 and rep["converted_frames"] == 3
    with open(info, "rb") as f:
        paths = [i["path"] for i in pickle.load(f)]
    objs = []
    for path in paths:
        with open(path, "rb") as f:
            objs.append(pickle.load(f))
    assert rep["gt_boxes"] == sum(len(o["annotations"]["gt_boxes"])
                                  for o in objs) > 0
    path, obj = paths[1], objs[1]
    # a frame as the port's converter wrote it before: no boxes
    for k in ("gt_boxes", "gt_names", "gt_num_points"):
        del obj["annotations"][k]
    with open(path, "wb") as f:
        pickle.dump(obj, f)
    with pytest.raises(DataTreeError, match="without the box labels"):
        create_data.main(argv)


@pytest.mark.parametrize("nsweeps", [1, 3])
def test_nusc_det_points_are_centerpoints(nsweeps, tmp_path):
    from lidarseg3d_torch.datasets import build_dataset
    from lidarseg3d_torch.datasets.nuscenes.common import (
        create_nuscenes_seg_infos)

    root = str(tmp_path)
    synthetic.write_semnusc_tree(
        root, scenes=("scene-0003",), samples=1, points=(300, 400),
        max_range=12.0, cams=(), boxes=2, sweeps=2, sweep_points=100)
    create_nuscenes_seg_infos(root, nsweeps=nsweeps, cam_chans=())
    info = os.path.join(root, f"infos_val_{nsweeps:02d}sweeps_segdet.pkl")
    if not os.path.exists(info):
        info = info.replace("_val_", "_train_")
    ds = build_dataset(dict(
        type="SemanticNuscDataset", root_path=root, info_path=info,
        nsweeps=nsweeps, test_mode=True, pipeline=[
            dict(type="LoadPointCloudFromFile",
                 dataset="SemanticNuscDataset", nsweeps=nsweeps),
            dict(type="LoadDetAnnotations"),
            dict(type="DetPreprocess", cfg=dict(mode="val"))]))
    got = ds[0]["points"]
    # the plain reference: each scan's float32 [x, y, z, intensity, ring]
    # rows, a sweep's moved into the key frame, and its time lag
    with open(info, "rb") as f:
        inf = pickle.load(f)[0]
    scans = [(np.fromfile(inf["lidar_path"], np.float32).reshape(-1, 5),
              np.eye(4), 0.0)]
    scans += [(np.fromfile(s["lidar_path"], np.float32).reshape(-1, 5),
               s["sweep_to_ref"], s["time_lag"])
              for s in inf["sweeps"][:nsweeps - 1]]
    assert len(scans) == nsweeps
    want = np.concatenate([np.column_stack(
        [p[:, :3] @ np.asarray(T, np.float64)[:3, :3].T + T[:3, 3],
         p[:, 3], np.full(len(p), lag)]) for p, T, lag in scans])
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got[:, :3], want[:, :3], atol=1e-4)
    np.testing.assert_array_equal(got[:, 3:], want[:, 3:].astype(np.float32))


def _boxes(rng, n, dim=7):
    b = np.concatenate([rng.uniform(-6, 6, (n, 3)),
                        rng.uniform(0.5, 4, (n, 3)),
                        rng.uniform(-np.pi, np.pi, (n, 1)),
                        rng.uniform(-2, 2, (n, dim - 7))], 1)
    return b.astype(np.float32)


def test_box_np_ops_and_targets_bit_exact():
    from lidarseg3d_tpu.core import box_np_ops as jb
    from lidarseg3d_tpu.core import center_targets as jt
    from lidarseg3d_torch.core import box_np_ops as tb
    from lidarseg3d_torch.core import center_targets as tt

    rng = np.random.default_rng(1)
    a, b = _boxes(rng, 9), _boxes(rng, 7)
    pts = rng.uniform(-8, 8, (500, 4)).astype(np.float32)
    np.testing.assert_array_equal(tb.bev_corners(a), jb.bev_corners(a))
    np.testing.assert_array_equal(tb.points_in_rbbox(pts, a, 0.1),
                                  jb.points_in_rbbox(pts, a, 0.1))
    np.testing.assert_array_equal(tb.boxes_bev_collide(a, b),
                                  jb.boxes_bev_collide(a, b))
    for dim in (7, 9):
        bx = _boxes(rng, 5, dim)
        for seed in range(4):
            out = []
            for mod in (tb, jb):
                g = np.random.default_rng(seed)
                x, p = mod.random_flip_both(bx, pts, g)
                x, p = mod.global_rotation(x, p, [-0.8, 0.8], g)
                x, p = mod.global_scaling(x, p, 0.95, 1.05, g)
                x, p = mod.global_translate(x, p, [0.2, 0.2, 0.1], g)
                out.append((x, p, g.random()))
            for u, v in zip(*out):
                np.testing.assert_array_equal(u, v)
        tasks = [[0, 1], [2]]
        cls = rng.integers(0, 3, 5)
        want = jt.assign_center_targets(bx, cls, tasks, (32, 32),
                                         [0.25, 0.25, 1.0], [-8, -8, -2],
                                         max_objs=6, min_overlap=0.1)
        got = tt.assign_center_targets(bx, cls, tasks, (32, 32),
                                       [0.25, 0.25, 1.0], [-8, -8, -2],
                                       max_objs=6, min_overlap=0.1)
        for w, g in zip(want, got):
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])
    assert tt.gaussian_radius(3.5, 2.0, 0.1) == jt.gaussian_radius(
        3.5, 2.0, 0.1)


def test_box_ops_iou_nms_against_jax():
    from lidarseg3d_tpu.ops import box_ops as jb
    from lidarseg3d_torch.ops import box_ops as tb

    rng = np.random.default_rng(2)
    a7, b7 = _boxes(rng, 24), _boxes(rng, 17)
    b7[:3] = a7[:3]  # identical boxes: IoU 1
    b7[3] = a7[4] + np.array([0.3, 0, 0, 0, 0, 0, 0], np.float32)
    bev = [0, 1, 3, 4, 6]
    t = torch.from_numpy
    np.testing.assert_allclose(
        tb.boxes_iou_bev(t(a7[:, bev]), t(b7[:, bev])).numpy(),
        np.asarray(jb.boxes_iou_bev(a7[:, bev], b7[:, bev])), atol=1e-5)
    np.testing.assert_allclose(tb.boxes_iou_3d(t(a7), t(b7)).numpy(),
                               np.asarray(jb.boxes_iou_3d(a7, b7)),
                               atol=1e-5)
    scores = rng.uniform(0, 1, 24).astype(np.float32)
    scores[5:9] = scores[2]  # ties: the first maximum wins
    for thr, max_out in ((0.1, 30), (0.0, 24)):
        want = jb.nms_bev(a7[:, bev], scores, thr, max_out)
        got = tb.nms_bev(t(a7[:, bev]), t(scores), thr, max_out)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for r, max_out in ((1.0, 10), (4.0, 30)):
        want = jb.circle_nms(a7[:, :2], scores, r, max_out)
        got = tb.circle_nms(t(a7[:, :2]), t(scores), r, max_out)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # batched rows equal row by row
    sb = np.stack([scores, scores[::-1].copy()])
    bb = np.stack([a7[:, bev], a7[::-1, bev].copy()])
    p, v = tb.nms_bev(t(bb), t(sb), 0.1, 30)
    for i in range(2):
        w = tb.nms_bev(t(bb[i]), t(sb[i]), 0.1, 30)
        np.testing.assert_array_equal(p[i].numpy(), w[0].numpy())
    ang = rng.uniform(-3, 3, 24).astype(np.float32)
    np.testing.assert_allclose(
        tb.rotate_points_along_z(t(a7[:, :4]), t(ang)).numpy(),
        np.asarray(jb.rotate_points_along_z(a7[:, :4], ang)), atol=1e-6)


def test_det_metrics_and_writers(tmp_path):
    from lidarseg3d_tpu.core import det_metrics as jm
    from lidarseg3d_tpu.datasets.nuscenes import det_submission as jn
    from lidarseg3d_torch.core import det_metrics as tm
    from lidarseg3d_torch.datasets.nuscenes import det_submission as tn
    from lidarseg3d_torch.datasets.waymo import det_submission as tw

    rng = np.random.default_rng(3)
    names = ["car", "pedestrian", "truck"]
    dets, gts, infos = {}, {}, {}
    for f in range(3):
        gt = _boxes(rng, 6)
        det = np.concatenate([gt[:4] + rng.normal(0, 0.3, (4, 7)).astype(
            np.float32), _boxes(rng, 5)])
        tok = f"t{f}"
        # 3 detections and 2 gt boxes of each class a frame: JAX's IoU
        # compiles once for that shape (its eager ops recompile per shape)
        valid = np.ones(9, bool)
        valid[rng.integers(0, 9)] = f == 2  # one invalid slot in 2 frames
        dets[tok] = {"box3d_lidar": det, "scores": rng.uniform(0, 1, 9),
                     "label_preds": np.arange(9) % 3, "valid": valid,
                     "velocity": rng.normal(0, 1, (9, 2))}
        gts[tok] = (gt, np.asarray([names[i % 3] for i in range(6)],
                                   dtype=object))
        T = np.eye(4)
        T[:3, 3] = rng.uniform(-100, 100, 3)
        infos[tok] = {"ref_to_global": T}
    fw = tm.group_detections_by_class(dets, gts, names)
    fj = jm.group_detections_by_class(dets, gts, names)
    for c in names:
        for a, b in zip(fw[c], fj[c]):
            for u, v in zip(a, b):
                np.testing.assert_array_equal(u, v)
    for fn in ("waymo_ap", "nusc_map"):
        got, want = getattr(tm, fn)(fw), getattr(jm, fn)(fj)
        assert set(got) == set(want)
        for k in want:
            if isinstance(want[k], dict):
                for m in want[k]:
                    np.testing.assert_allclose(got[k][m], want[k][m],
                                               atol=1e-6)
            else:
                np.testing.assert_allclose(got[k], want[k], atol=1e-6)
    cls = ("car", "pedestrian", "truck")
    jn.detections_to_nusc_json(dets, infos, str(tmp_path / "j.json"), cls)
    tn.detections_to_nusc_json(dets, infos, str(tmp_path / "t.json"), cls)
    assert (tmp_path / "j.json").read_text() == (
        tmp_path / "t.json").read_text()
    with pytest.raises(ImportError):
        tw.write_detection_objects(dets, str(tmp_path))


PIPE_CFG = dict(
    tasks=[dict(num_class=1, class_names=["VEHICLE"]),
           dict(num_class=2, class_names=["PEDESTRIAN", "CYCLIST"])],
    pc_range=[-12.8, -12.8, -2.0, 12.8, 12.8, 4.0],
    voxel_size=[0.2, 0.2, 0.375], out_size_factor=8, max_objs=40,
    gaussian_overlap=0.1)


def _pipeline(db_path, mode, double_flip=False):
    names = ["VEHICLE", "PEDESTRIAN", "CYCLIST"]
    prep = dict(mode=mode, shuffle_points=mode == "train",
                class_names=names, min_points_in_gt=3,
                global_rot_noise=[-0.78, 0.78],
                global_scale_noise=[0.95, 1.05], global_translate_std=0.2,
                db_sampler=dict(db_info_path=db_path, min_points=5,
                                sample_groups=dict(VEHICLE=6, PEDESTRIAN=4,
                                                   CYCLIST=4)))
    vox = dict(range=PIPE_CFG["pc_range"], voxel_size=PIPE_CFG["voxel_size"],
               max_points_in_voxel=5, max_voxel_num=[3000, 3000])
    pipe = [dict(type="LoadPointCloudFromFile",
                 dataset="SemanticWaymoDataset"),
            dict(type="LoadDetAnnotations"),
            dict(type="DetPreprocess", cfg=prep)]
    if double_flip:
        pipe.append(dict(type="DoubleFlip"))
    pipe += [dict(type="SegVoxelization", cfg=vox)]
    if mode == "train":
        pipe.append(dict(type="DetAssignLabel", cfg=PIPE_CFG))
    return pipe + [dict(type="DetReformat")]


def _same(a, b, path="frame"):
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (u, v) in enumerate(zip(a, b)):
            _same(u, v, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == np.asarray(b).dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


@pytest.fixture(scope="module")
def waymo_det_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("wdet"))
    synthetic.write_semanticwaymo_tree(
        root, splits=("train", "val"), frames=3, top_cols=24,
        max_range=12.0, short_points=400, cams=(), boxes=9)
    return root


def test_det_pipeline_and_gt_database(waymo_det_tree, tmp_path):
    """create_gt_database of both packages on the seeded tree (the port's
    through ``create_data waymo_gt_database``), then the train pipeline
    with the DBSampler (both on the JAX database), double-flip val and the
    collate, bit for bit over two seeds."""
    from lidarseg3d_tpu.datasets import build_dataset as jbuild
    from lidarseg3d_tpu.datasets.batching import collate_segnet as jcol
    from lidarseg3d_tpu.datasets.pipelines.det_pipeline import (
        create_gt_database)
    from lidarseg3d_torch.datasets import build_dataset as tbuild
    from lidarseg3d_torch.datasets.batching import collate_segnet as tcol
    from lidarseg3d_torch.tools import create_data

    root = waymo_det_tree
    jdir = str(tmp_path / "jax_db")
    info = os.path.join(root, "infos_train_01sweeps_segdet.pkl")
    ds = jbuild(dict(type="SemanticWaymoDataset", root_path=root,
                     info_path=info, pipeline=[
                         dict(type="LoadPointCloudFromFile",
                              dataset="SemanticWaymoDataset"),
                         dict(type="LoadDetAnnotations")]))
    jdb = create_gt_database(ds, jdir, ["VEHICLE", "PEDESTRIAN", "CYCLIST"],
                             min_points=5)
    tdir = str(tmp_path / "port_db")
    tdb = create_data.main(["waymo_gt_database", "--root", root,
                            "--out_dir", tdir])[0]
    with open(jdb, "rb") as f:
        jinf = pickle.load(f)
    with open(tdb, "rb") as f:
        tinf = pickle.load(f)
    assert sum(len(v) for v in jinf.values()) >= 12
    for c in jinf:
        assert len(jinf[c]) == len(tinf[c])
        for u, v in zip(jinf[c], tinf[c]):
            assert (u["num_points"], os.path.basename(u["path"])) == (
                v["num_points"], os.path.basename(v["path"]))
            np.testing.assert_array_equal(u["box"], v["box"])
            np.testing.assert_array_equal(np.fromfile(u["path"], np.float32),
                                          np.fromfile(v["path"], np.float32))
    for mode, split, flip in (("train", "train", False),
                              ("val", "val", True)):
        kw = dict(type="SemanticWaymoDataset", root_path=root,
                  info_path=os.path.join(
                      root, f"infos_{split}_01sweeps_segdet.pkl"),
                  test_mode=mode != "train")
        jd = jbuild(dict(kw, pipeline=_pipeline(jdb, mode, flip)))
        td = tbuild(dict(kw, pipeline=_pipeline(jdb, mode, flip)))
        for seed in (0, 1):
            jf, tf = [], []
            for i in range(len(jd)):
                # the JAX det train pipeline needs the key its
                # SegVoxelization reads (ROADMAP §C); its tests set it
                s_j = _run_jax(jd, i, seed)
                jf.extend(s_j if isinstance(s_j, list) else [s_j])
                s_t = td.get_sensor_data(i, rng=np.random.default_rng(
                    seed * 10 + i))
                tf.extend(s_t if isinstance(s_t, list) else [s_t])
            _same(tf, jf)
            if mode == "train":
                assert sum(int(f["gt_boxes_and_cls"][:, 7].astype(bool).sum())
                           for f in tf) > 9  # sampled boxes pasted
            _same(tcol(tf, 3000, 4096), jcol(jf, 3000, 4096))


def _run_jax(ds, i, seed):
    """The JAX dataset's frame i, with points_with_labels set after
    DetPreprocess as the JAX package's own det pipeline test does."""
    info = ds.load_infos(i) if hasattr(ds, "load_infos") else None
    sample = {"mode": "val" if ds.test_mode else "train",
              "metadata": {"token": info["token"], "path": info["path"],
                           "num_point_features": ds._num_point_features},
              "nsweeps": ds.nsweeps,
              "rng": np.random.default_rng(seed * 10 + i)}
    for t in ds.pipeline.transforms:
        sample, info = t(sample, info)
        if type(t).__name__ == "DetPreprocess":
            sample["points_with_labels"] = sample["points"]
    return sample
