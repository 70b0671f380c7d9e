"""The port's SemanticWaymo host side against the JAX package's, on seeded
trees of synthetic.write_semanticwaymo_tree (converted frames: a TOP
lidar of 64 rows with second returns and the four short-range lidars,
labels on the TOP lidar's returns only, five cameras in their own pixel
frames at a tenth of the published widths, 1920x1280 and 1920x886
scaled) and on frames of tests/test_waymo.py's ``write_fixture``:

- the val and train frames of both published SemanticWaymo configs'
  pipelines (cut to the mini model's grid and 96x64 images by
  ``synthetic.write_mini_waymo_config``; the side cameras scale
  anisotropically) equal the JAX ``build_dataset(...)`` frames bit for
  bit, over two seeds, with their points_cp in each camera's pixels;
- the two-sweep branch (``p @ T[:3, :3].T + T[:3, 3]`` and a time-lag
  column; the sweep's points without a camera) equals JAX's;
- at the published grid (0.1 x 0.1 x 0.15 m over +-75.2 m, 240,000
  voxels, 196,608 points): a frame with points on and beside every face
  of the range, and a frame of 330,000 points that overflows both
  capacities, voxelize and collate exactly as in the JAX package (the
  overflow keeps the smallest keys, the collate cuts the points);
- the shuffled train frame keeps each point's label (the TOP lidar's
  labels, the other points' padded 0) as JAX's does;
- ``evaluation`` equals JAX's (mIoU and every class) with predictions
  longer than the labelled points, on one process and, sharded, on two
  gloo ranks (each frame counted once; the JAX package counts a padding
  repeat twice, ROADMAP §C fault 12);
- ``_label_range_image`` and the TOP slices equal JAX's, and the tree's
  slices and range-image cells pick the TOP lidar's returns;
- ``create_data semanticwaymo --dry-data`` equals JAX's
  ``validate_semanticwaymo`` on a good tree and three broken ones; the
  converter, the tool without ``--dry-data`` and the test-split
  submission raise as JAX's do without waymo_open_dataset, and neither
  module imports a framework at module level;
- the port's Config loads a derived config's base afresh each time (the
  JAX package's carries one load's edits into the next, ROADMAP §C
  fault 15).

Integers and floats exact throughout (the pipelines are the same numpy
arithmetic on both sides); mIoUs equal."""

import copy
import os
import pickle
import sys

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from lidarseg3d_tpu.datasets import build_dataset as jbuild_dataset
from lidarseg3d_tpu.datasets import collate_segnet as jcollate
from lidarseg3d_tpu.datasets import validate as jvalidate
from lidarseg3d_tpu.datasets.waymo import converter as jconverter
from lidarseg3d_tpu.datasets.waymo import submission as jsub
from lidarseg3d_torch.datasets import build_dataset, collate_segnet
from lidarseg3d_torch.datasets import validate
from lidarseg3d_torch.datasets.waymo import converter, submission
from lidarseg3d_torch.synthetic import (MINI_WAYMO_CAMS,
                                        write_mini_waymo_config,
                                        write_semanticwaymo_tree)
from lidarseg3d_torch.tools import create_data
from lidarseg3d_torch.utils.config import Config

from _torch_ddp import run_ranks
from _torch_port_waymo_ranks import waymo_eval_rank
from test_waymo import write_fixture

CFG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "configs", "semanticwaymo", "MSeg3D")
CONFIGS = {"mseg3d": os.path.join(
    CFG, "semwaymo_avgvfe_unetscn3d_hrnetw18_lr1en2_e12.py"),
    "baseline": os.path.join(
        CFG, "semwaymo_avgvfe_unetscn3d_lidarbaseline_lr1en2_e12.py")}
PUBLISHED_VOXELS = dict(range=[-75.2, -75.2, -2, 75.2, 75.2, 4],
                        voxel_size=[0.1, 0.1, 0.15], max_points_in_voxel=5,
                        max_voxel_num=[240000, 240000])


def equal_frames(got, want, what):
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for k, w in want.items():
        if k == "metadata":
            assert got[k] == w, what
        else:
            assert got[k].dtype == w.dtype and np.array_equal(got[k], w), \
                (what, k)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("waymo"))
    infos = write_semanticwaymo_tree(root, frames=2, seed=3, top_cols=24,
                                     max_range=12.0, short_points=400,
                                     cam_hw=MINI_WAYMO_CAMS)
    return dict(root=root, infos=infos)


def split_cfg(tree, name, split, tmp):
    path = write_mini_waymo_config(str(tmp / f"{name}.py"), CONFIGS[name],
                                   tree["root"])
    return copy.deepcopy(Config.fromfile(path).data[split].to_dict())


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("split", ["val", "train"])
def test_frames_equal_jax(tree, name, split, tmp_path):
    d = split_cfg(tree, name, split, tmp_path)
    ds, jds = build_dataset(copy.deepcopy(d)), jbuild_dataset(
        copy.deepcopy(d))
    assert len(ds) == len(jds) == 2
    for seed in (0, 1):
        got = ds.get_sensor_data(1, rng=np.random.default_rng(seed))
        want = jds.get_sensor_data(1, rng=np.random.default_rng(seed))
        equal_frames(got, want, (name, split, seed))
        assert got["points"].shape[1] == 5
        if name == "mseg3d":
            assert got["images"].shape == (5, 64, 96, 3)
            cam = got["points_cuv"][:, 1][got["points_cuv"][:, 0] > 0]
            # every camera sees points; the index maps 1..5 to [-1, 1]
            assert set(np.round((cam + 1) * 2).astype(int)) == set(range(5))


def test_points_cp_in_each_cameras_pixels(tree):
    with open(tree["infos"]["validation"], "rb") as f:
        info = pickle.load(f)[0]
    with open(info["path"], "rb") as f:
        cp = pickle.load(f)["lidars"]["points_cp"]
    for cam, (W, H) in MINI_WAYMO_CAMS.items():
        sel = cp[:, 0] == int(cam)
        assert sel.sum() > 20, cam
        assert cp[sel, 1].max() < W and cp[sel, 2].max() < H, cam
    # the side cameras' rows reach beyond the front ones' 886/1280 share
    side = cp[cp[:, 0] == 4, 2]
    assert side.max() > 0.9 * 89


def test_two_sweep_branch_equals_jax(tree):
    d = dict(type="SemanticWaymoDataset", info_path=tree["infos"]["training"],
             root_path=tree["root"], nsweeps=2, cam_names=["1", "2"],
             cam_attributes={c: dict(mean=[0.4] * 3, std=[0.3] * 3)
                             for c in ("1", "2")},
             img_resized_shape=(96, 64),
             pipeline=[dict(type="LoadPointCloudFromFile",
                            dataset="SemanticWaymoDataset", use_img=True),
                       dict(type="LoadImageFromFile", use_img=True),
                       dict(type="LoadPointCloudAnnotations")])
    got = build_dataset(copy.deepcopy(d)).get_sensor_data(1)
    want = jbuild_dataset(copy.deepcopy(d)).get_sensor_data(1)
    for k in ("points", "points_cp"):
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k],
                                                                want[k]), k
    for k in ("point_sem_labels", "point_inst_labels"):
        assert np.array_equal(got["annotations"][k],
                              want["annotations"][k]), k
    for g, w in zip(got["images"], want["images"], strict=True):
        assert np.array_equal(g, w)
    with open(tree["infos"]["training"], "rb") as f:
        n0 = len(pickle.load(open(pickle.load(f)[1]["path"], "rb"))[
            "lidars"]["points_xyz"])
    pts = got["points"]
    assert pts.shape[1] == 6 and (pts[:n0, 5] == 0).all() and np.allclose(
        pts[n0:, 5], 0.1)
    assert (got["points_cp"][n0:] == -100).all()


def write_frame(path, xyz, labels=None, n_seg=None):
    n = len(xyz)
    rng = np.random.default_rng(n)
    labels = rng.integers(0, 23, n).astype(np.uint8) if labels is None \
        else labels
    obj = {"token": os.path.basename(path)[:-4],
           "lidars": {"points_xyz": xyz.astype(np.float32),
                      "points_feature": rng.uniform(0, 1, (n, 2)).astype(
                          np.float32),
                      "points_cp": np.full((n, 3), -100.0, np.float32)},
           "annotations": {"point_sem_labels": labels,
                           "num_seg_points": n_seg or len(labels)},
           "cam_paths": {}}
    with open(path, "wb") as f:
        pickle.dump(obj, f)
    return {"token": obj["token"], "path": path}


def border_points():
    """Points on and just inside / outside every face of the published
    range, at voxel boundaries, and fp32's 1503.9999 cell count."""
    lo, hi = np.float32(-75.2), np.float32(75.2)
    near = [lo, np.nextafter(lo, np.float32(0)), np.nextafter(lo, -np.inf),
            hi, np.nextafter(hi, np.float32(0)), np.nextafter(hi, np.inf),
            np.float32(75.1), np.float32(-75.1), np.float32(0.0),
            np.float32(0.1), np.float32(-0.1), np.float32(75.19999)]
    zs = [np.float32(v) for v in (-2.0, -1.99999, -2.00001, 4.0, 3.99999,
                                  4.00001, 0.0, 0.15, -1.85, 3.85)]
    grid = np.array(np.meshgrid(near, near, zs, indexing="ij")).reshape(
        3, -1).T
    rng = np.random.default_rng(0)
    return np.concatenate([grid, rng.uniform(-75.2, 75.2, (500, 3)) * [1, 1,
                                                                  0.04]
                           + [0, 0, 1]]).astype(np.float32)


@pytest.fixture(scope="module")
def edge_infos(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("waymo_edges")
    rng = np.random.default_rng(1)
    over = np.concatenate([rng.uniform(-75.2, 75.2, (330000, 2)),
                           rng.uniform(-2.0, 4.0, (330000, 1))], 1)
    infos = [write_frame(str(tmp / "border.pkl"), border_points()),
             write_frame(str(tmp / "overflow.pkl"), over,
                         labels=rng.integers(0, 23, 200000).astype(
                             np.uint8), n_seg=200000)]
    path = str(tmp / "infos.pkl")
    with open(path, "wb") as f:
        pickle.dump(infos, f)
    return dict(path=path, root=str(tmp))


@pytest.mark.parametrize("mode", ["val", "train"])
def test_border_and_overflow_frames_equal_jax(edge_infos, mode):
    train = mode == "train"
    pipe = [dict(type="LoadPointCloudFromFile",
                 dataset="SemanticWaymoDataset")]
    if train:
        pipe.append(dict(type="LoadPointCloudAnnotations"))
    pipe += [dict(type="SegPreprocess", cfg=dict(
        mode=mode, shuffle_points=train, npoints=400000,
        global_rot_noise=[-0.78539816, 0.78539816],
        global_scale_noise=[0.95, 1.05], global_translate_std=0.5)),
        dict(type="SegVoxelization", cfg=PUBLISHED_VOXELS)]
    if train:
        pipe.append(dict(type="SegAssignLabel",
                         cfg=dict(voxel_label_enc="compact_value")))
    pipe.append(dict(type="Reformat"))
    d = dict(type="SemanticWaymoDataset", info_path=edge_infos["path"],
             root_path=edge_infos["root"], pipeline=pipe,
             test_mode=not train)
    ds, jds = build_dataset(copy.deepcopy(d)), jbuild_dataset(
        copy.deepcopy(d))
    frames = []
    for i in range(2):
        got = ds.get_sensor_data(i, rng=np.random.default_rng(i))
        want = jds.get_sensor_data(i, rng=np.random.default_rng(i))
        equal_frames(got, want, (mode, i))
        frames.append((got, want))
    border, over = frames[0][0], frames[1][0]
    if not train:  # unshuffled: faces checked where the points sit
        c = border["coordinates"]
        assert c[:, 2].max() == 1503 and c[:, 1].max() == 1503
        assert c[:, 0].max() == 39 and c.min() == 0
    assert len(over["voxels"]) == 240000  # the capacity: overflowed
    got = collate_segnet([f[0] for f in frames], 240000, 196608)
    want = jcollate([f[1] for f in frames], 240000, 196608)
    equal_frames(got, want, (mode, "collate"))
    assert got["points"].shape[:2] == (2, 196608)


def test_shuffled_train_frame_keeps_labels(tree, tmp_path):
    d = split_cfg(tree, "baseline", "train", tmp_path)
    d["pipeline"] = [st for st in d["pipeline"]
                     if st["type"] not in ("SegVoxelization",
                                           "SegAssignLabel", "Reformat")]
    ds, jds = build_dataset(copy.deepcopy(d)), jbuild_dataset(
        copy.deepcopy(d))
    got = ds.get_sensor_data(0, rng=np.random.default_rng(5))
    want = jds.get_sensor_data(0, rng=np.random.default_rng(5))
    idx = got["points_shuffle_idx"]
    assert np.array_equal(idx, want["points_shuffle_idx"])
    with open(ds.load_infos(0)["path"], "rb") as f:
        obj = pickle.load(f)
    n_seg = obj["annotations"]["num_seg_points"]
    n = len(obj["lidars"]["points_xyz"])
    full = np.zeros(n, np.int32)
    full[:n_seg] = obj["annotations"]["point_sem_labels"]
    lab = got["annotations"]["point_sem_labels"]
    assert np.array_equal(lab, want["annotations"]["point_sem_labels"])
    assert np.array_equal(lab, full[idx])
    assert (lab[idx >= n_seg] == 0).all() and n_seg < n


def detections(ds, seed):
    rng = np.random.default_rng(seed)
    dets = {}
    for info in ds._infos:
        gt = ds.get_anno_for_eval(info["token"])["point_sem_labels"]
        with open(ds.load_infos(ds._infos.index(info))["path"], "rb") as f:
            n = len(pickle.load(f)["lidars"]["points_xyz"])
        pred = rng.integers(0, 23, n)
        keep = rng.random(len(gt)) < 0.6
        pred[:len(gt)][keep] = gt[keep]
        dets[info["token"]] = {"pred_point_sem_labels": pred.astype(
            np.int32)}
    return dets


def same_results(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == v or (np.isnan(v) and np.isnan(got[k])), k


def test_evaluation_equals_jax(tmp_path):
    info_path = write_fixture(str(tmp_path), frames=3)
    d = dict(type="SemanticWaymoDataset", info_path=info_path,
             root_path=str(tmp_path), pipeline=[], test_mode=True)
    ds, jds = build_dataset(copy.deepcopy(d)), jbuild_dataset(
        copy.deepcopy(d))
    dets = detections(ds, 2)
    got, _ = ds.evaluation(dets)
    want, _ = jds.evaluation(dets)
    same_results(got["results"], want["results"])
    assert 0 < got["results"]["mIoU"] < 100 and len(got["results"]) == 23
    # two gloo ranks: shards [0, 2] and [1, 0], frame 0's repeat dropped
    r0, r1 = run_ranks(waymo_eval_rank, 2, tmp_path / "ranks", info_path,
                       str(tmp_path), dets)
    assert r0["tokens"] == ["seg0", "seg2"] and r1["tokens"] == ["seg1"]
    same_results(r0["results"], want["results"])
    same_results(r1["results"], want["results"])
    with pytest.raises(RuntimeError, match="waymo_open_dataset"):
        ds.evaluation(dets, output_dir=str(tmp_path), testset=True)
    with pytest.raises(RuntimeError, match="waymo_open_dataset"):
        jds.evaluation(dets, output_dir=str(tmp_path), testset=True)


def test_label_range_image_and_top_slices_equal_jax(tree):
    assert (submission.TOP_LIDAR_ROW_NUM, submission.TOP_LIDAR_COL_NUM) == (
        jsub.TOP_LIDAR_ROW_NUM, jsub.TOP_LIDAR_COL_NUM) == (64, 2650)
    rng = np.random.default_rng(0)
    cells = rng.choice(64 * 2650, 700, replace=False)
    idx = np.stack([cells % 2650, cells // 2650], -1).astype(np.int32)
    for n_lab in (700, 500):  # fewer labels than cells: the first ones
        labels = rng.integers(1, 23, n_lab).astype(np.int32)
        got = submission._label_range_image(idx, labels)
        want = jsub._label_range_image(idx, labels)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert converter.top_slices_of([0, 95], [40, 15]) == {
        "ri1": [0, 40], "ri2": [95, 15]}
    with open(tree["infos"]["validation"], "rb") as f:
        info = pickle.load(f)[0]
    with open(info["path"], "rb") as f:
        obj = pickle.load(f)
    lid, labels = obj["lidars"], obj["annotations"]["point_sem_labels"]
    sl, ri = lid["top_slices"], lid["top_ri_indexing"]
    r1, r2 = submission.top_return_labels(labels, sl)
    assert len(r1) == len(ri["ri1"]) and len(r2) == len(ri["ri2"])
    assert len(r1) + len(r2) == obj["annotations"]["num_seg_points"]
    img = submission._label_range_image(ri["ri1"], r1)
    assert np.array_equal(img[ri["ri1"][:, 1], ri["ri1"][:, 0], 1], r1)
    # the JAX writer's slicing of the same flat labels
    assert np.array_equal(r2, labels[sl["ri2"][0]: sl["ri2"][0]
                                     + sl["ri2"][1]])


def test_dry_data_equals_jax(tmp_path, capsys):
    good = tmp_path / "good"
    (good / "training").mkdir(parents=True)
    for i in range(3):
        (good / "training" / f"seg{i}.tfrecord").write_bytes(b"\0" * 8)
    rep = create_data.main(["semanticwaymo", "--root", str(good),
                            "--dry-data"])
    assert rep == jvalidate.validate_semanticwaymo(str(good))
    assert rep["tfrecords"] == 3 and "dry-data OK" in capsys.readouterr().out
    empty = tmp_path / "empty"
    (empty / "validation").mkdir(parents=True)
    (empty / "validation" / "a.tfrecord").write_bytes(b"")
    (tmp_path / "none" / "training").mkdir(parents=True)
    for root, split in ((tmp_path / "missing", "training"),
                        (tmp_path / "none", "training"),
                        (empty, "validation")):
        with pytest.raises(jvalidate.DataTreeError) as want:
            jvalidate.validate_semanticwaymo(str(root), split=split)
        with pytest.raises(validate.DataTreeError) as got:
            create_data.main(["semanticwaymo", "--root", str(root),
                              "--dry-data", "--split", split])
        assert str(got.value) == str(want.value)


def test_converter_raises_as_jax_without_waymo_open_dataset(tmp_path,
                                                            monkeypatch):
    # neither library importable, as on a machine without them (importing
    # an installed tensorflow alone takes ~10 s)
    for mod in ("tensorflow", "waymo_open_dataset"):
        monkeypatch.setitem(sys.modules, mod, None)
    with pytest.raises(ImportError) as want:
        jconverter.create_semanticwaymo_infos(str(tmp_path))
    with pytest.raises(ImportError) as got:
        converter.create_semanticwaymo_infos(str(tmp_path))
    assert str(got.value) == str(want.value)
    with pytest.raises(ImportError, match="waymo_open_dataset"):
        create_data.main(["semanticwaymo", "--root", str(tmp_path)])
    # the detection gt database is ported: without converted training
    # frames it finds no infos, as the JAX tool does
    with pytest.raises(FileNotFoundError, match="infos_train_01sweeps"):
        create_data.main(["waymo_gt_database", "--root", str(tmp_path)])


def test_converter_and_submission_import_no_framework():
    """Both are host-side: no torch or JAX at module level (the proto and
    tfrecord libraries are imported where they are used)."""
    import ast

    for mod in (converter, submission):
        tree = ast.parse(open(mod.__file__).read())
        top = [n.names[0].name if isinstance(n, ast.Import) else n.module
               for n in tree.body
               if isinstance(n, (ast.Import, ast.ImportFrom))]
        assert not {m.split(".")[0] for m in top} & {
            "torch", "jax", "tensorflow", "waymo_open_dataset"}, top


def test_a_derived_config_leaves_its_base_unchanged(tmp_path):
    """The lidar baseline star-imports the MSeg3D config and edits its
    ``data`` in place; a copy that also sets the loader's mode must not
    carry that into the next load of the baseline (ROADMAP §C fault 15:
    the JAX package's Config keeps the imported base module and does)."""
    from lidarseg3d_tpu.utils.config import Config as JConfig

    edited = tmp_path / "thread.py"
    with open(CONFIGS["baseline"]) as f:
        edited.write_text(f.read() + "\ndata['worker_mode'] = 'thread'\n")
    for cls, leaks in ((JConfig, True), (Config, False)):
        assert cls.fromfile(str(edited)).data.worker_mode == "thread"
        again = cls.fromfile(CONFIGS["baseline"]).data
        assert ("worker_mode" in again) == leaks, cls
        assert [st["type"] for st in again.train.pipeline][1] == \
            "LoadPointCloudAnnotations"
        full = cls.fromfile(CONFIGS["mseg3d"]).data.train.pipeline
        assert full[1]["type"] == "LoadImageFromFile"

