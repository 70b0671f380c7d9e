"""The port's nuScenes host side against the JAX package's and cv2, on a
seeded six-camera tree from synthetic.write_semnusc_tree (a val and a
train scene of two key frames each, 30,000-34,688 points and six
1600x900 JPEGs a frame, the published sizes).

- ``create_nuscenes_seg_infos`` writes the JAX package's infos, key for
  key and array for array, with and without cameras, at ``nsweeps`` 1 and
  3, and on the tree with annotation tables (boxes and velocities); the
  tool ``tools.create_data`` writes the same files and its ``--dry-data``
  check passes; ``semanticwaymo`` (the converter) raises without
  waymo_open_dataset, ``waymo_gt_database`` (detection) is not ported.
- ``read_jpeg_bgr`` equals ``cv2.imread`` exactly (tolerance 0) on files
  cv2 wrote at qualities 30 / 75 / 95, at 1600x900, 17x9 and 53x37, in
  4:2:0, 4:2:2 and 4:4:4, with and without a restart interval, grey too,
  and on the tree's own files; files of ``write_jpeg_bgr`` decode in cv2
  to the same pixels as in ``read_jpeg_bgr``, which are cv2's JPEG round
  trip of the image (jpeg.py); progressive files and an EXIF rotation
  raise, and so does the reader when its C helper cannot be built.
- The val and train frames of the published config's pipelines equal the
  JAX ``build_dataset(...)`` frames bit for bit, over two seeds.
- ``evaluation`` equals the JAX dataset's on the same predictions, and
  the test-split ``{lidar_sd_token}_lidarseg.bin`` files are the same
  bytes.
- The train batches of the loader's ``process`` and ``shm`` workers equal
  its threads' bit for bit."""

import copy
import json
import os
import pickle
import shutil

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from lidarseg3d_tpu.datasets import build_dataset as jbuild_dataset
from lidarseg3d_tpu.datasets.nuscenes.common import (
    create_nuscenes_seg_infos as jinfos)
from lidarseg3d_torch.datasets import build_dataset
from lidarseg3d_torch.datasets.nuscenes.common import (
    create_nuscenes_seg_infos)
from lidarseg3d_torch.datasets.nuscenes.metadata import CAM_CHANS
from lidarseg3d_torch.datasets.pipelines import jpeg
from lidarseg3d_torch.datasets.pipelines import jpeg_read as jr
from lidarseg3d_torch.synthetic import write_semnusc_tree
from lidarseg3d_torch.tools import create_data
from lidarseg3d_torch.utils.config import Config

from test_torch_port_support import NUSC_CONFIG

SCENES = ("scene-0003", "scene-0001")  # official val, train


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("nusc"))
    write_semnusc_tree(root, scenes=SCENES, samples=2, seed=6)
    return root


def equal(got, want, path=""):
    """Exact equality of nested infos: keys, list lengths, array dtypes
    and values, and the type of every other value."""
    assert type(got) is type(want), (path, type(got), type(want))
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            equal(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert np.array_equal(got, want), path
    else:
        assert got == want, (path, got, want)


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _annotated(tree, root):
    """A copy of the tree's tables with three annotated objects a sample,
    linked across each scene's samples (so velocities exist)."""
    v = "v1.0-trainval"
    shutil.copytree(os.path.join(tree, v), os.path.join(root, v))
    with open(os.path.join(root, v, "sample.json")) as f:
        samples = json.load(f)
    rng = np.random.default_rng(3)
    cats = ["vehicle.car", "human.pedestrian.adult", "animal"]
    anns, insts = [], []
    by_scene = {}
    for smp in samples:
        by_scene.setdefault(smp["scene_token"], []).append(smp)
    for scene, rows in by_scene.items():
        for k in range(3):
            inst = f"inst_{scene}_{k}"
            insts.append(dict(token=inst, category_token=f"cat{k}"))
            toks = [f"ann_{r['token']}_{k}" for r in rows]
            for i, r in enumerate(rows):
                anns.append(dict(
                    token=toks[i], sample_token=r["token"],
                    instance_token=inst,
                    translation=rng.uniform(-500, 500, 3).tolist(),
                    rotation=rng.normal(size=4).tolist(),
                    size=rng.uniform(0.5, 5.0, 3).tolist(),
                    num_lidar_pts=int(rng.integers(0, 3)), num_radar_pts=0,
                    prev=toks[i - 1] if i else "",
                    next=toks[i + 1] if i + 1 < len(rows) else ""))
    for name, rows in (("sample_annotation", anns), ("instance", insts),
                       ("category", [dict(token=f"cat{k}", name=c)
                                     for k, c in enumerate(cats)])):
        with open(os.path.join(root, v, f"{name}.json"), "w") as f:
            json.dump(rows, f)
    return root


@pytest.mark.parametrize("case", ["cams", "no_cams", "sweeps3",
                                  "annotations"])
def test_infos_equal_jax(tree, tmp_path, case):
    root = _annotated(tree, str(tmp_path / "ann")) \
        if case == "annotations" else tree
    kw = dict(nsweeps=3 if case == "sweeps3" else 1,
              cam_chans=None if case == "no_cams" else CAM_CHANS)
    got = create_nuscenes_seg_infos(root, out_dir=str(tmp_path / "t"), **kw)
    want = jinfos(root, out_dir=str(tmp_path / "j"), **kw)
    for g, w in zip(got, want, strict=True):
        assert os.path.basename(g) == os.path.basename(w)
        gi, wi = _load(g), _load(w)
        assert len(gi) == 2
        equal(gi, wi)
    train = _load(got[0])
    if case == "sweeps3":
        assert [len(i["sweeps"]) for i in train] == [0, 1]
    if case == "annotations":
        assert all(len(i["gt_boxes"]) > 0 for i in train)
    if case == "cams":
        assert set(train[0]["cam_paths"]) == set(CAM_CHANS)


def test_create_data_tool(tree, tmp_path, capsys):
    paths = create_data.main(["semanticnusc", "--root", tree, "--cams",
                              "--out_dir", str(tmp_path)])
    want = jinfos(tree, cam_chans=CAM_CHANS, out_dir=str(tmp_path / "j"))
    for g, w in zip(paths, want, strict=True):
        equal(_load(g), _load(w))
    rep = create_data.main(["semanticnusc", "--root", tree, "--dry-data"])
    assert rep["lidarseg_records"] == rep["checked"] == 4
    assert "dry-data OK" in capsys.readouterr().out
    # the Waymo converter needs waymo_open_dataset, absent here;
    # a nuScenes tree holds no converted Waymo frames for the Waymo
    # converter or the detection gt database
    with pytest.raises(ImportError, match="waymo_open_dataset"):
        create_data.main(["semanticwaymo", "--root", tree])
    with pytest.raises(FileNotFoundError, match="infos_train_01sweeps"):
        create_data.main(["waymo_gt_database", "--root", tree])


def _smooth(rng, H, W):
    yy, xx = np.mgrid[0:H, 0:W]
    img = np.stack([np.sin(xx * 0.03 * (c + 1) + yy * 0.02) * 100 + 128
                    for c in range(3)], -1) + rng.normal(0, 10, (H, W, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


SAMPLING = {"4:2:0": 0x221111, "4:2:2": 0x211111, "4:4:4": 0x111111}


@pytest.mark.parametrize("hw", [(900, 1600), (9, 17), (37, 53)])
@pytest.mark.parametrize("quality", [30, 75, 95])
def test_read_jpeg_equals_cv2(tmp_path, hw, quality):
    rng = np.random.default_rng(hw[0] + quality)
    img = _smooth(rng, *hw)
    for name, factor in SAMPLING.items():
        for rst in (0, 2):
            params = [cv2.IMWRITE_JPEG_QUALITY, quality,
                      cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor]
            if rst:
                params += [cv2.IMWRITE_JPEG_RST_INTERVAL, rst]
            path = str(tmp_path / f"{name}_{rst}.jpg")
            assert cv2.imwrite(path, img, params)
            got = jr.read_jpeg_bgr(path)
            assert got.dtype == np.uint8 and got.shape == hw + (3,)
            assert np.array_equal(got, cv2.imread(path)), (name, rst)
    path = str(tmp_path / "grey.jpg")
    cv2.imwrite(path, img[..., 1], [cv2.IMWRITE_JPEG_QUALITY, quality])
    assert np.array_equal(jr.read_jpeg_bgr(path), cv2.imread(path))


@pytest.mark.parametrize("hw", [(900, 1600), (9, 17), (37, 53), (1, 2)])
def test_write_jpeg_decodes_alike(tmp_path, hw):
    rng = np.random.default_rng(sum(hw))
    img = _smooth(rng, *hw)
    for quality in (30, 95):
        path = str(tmp_path / "own.jpg")
        jr.write_jpeg_bgr(path, img, quality)
        got = jr.read_jpeg_bgr(path)
        assert np.array_equal(got, cv2.imread(path))
        assert np.array_equal(got, jpeg.jpeg_round_trip(img, quality))


def test_tree_images_equal_cv2(tree):
    cams = os.path.join(tree, "samples", "CAM_FRONT")
    for f in sorted(os.listdir(cams))[:2]:
        p = os.path.join(cams, f)
        assert np.array_equal(jr.read_jpeg_bgr(p), cv2.imread(p))


def _exif_rotated(data, orientation):
    """``data`` with an APP1 Exif segment whose IFD0 holds one
    Orientation entry, after SOI."""
    tiff = (b"II*\0" + (8).to_bytes(4, "little") + (1).to_bytes(2, "little")
            + (0x0112).to_bytes(2, "little") + (3).to_bytes(2, "little")
            + (1).to_bytes(4, "little") + orientation.to_bytes(2, "little")
            + b"\0\0" + (0).to_bytes(4, "little"))
    seg = b"Exif\0\0" + tiff
    return data[:2] + b"\xff\xe1" + (len(seg) + 2).to_bytes(2, "big") \
        + seg + data[2:]


def test_unsupported_files_raise(monkeypatch):
    img = _smooth(np.random.default_rng(1), 24, 40)
    prog = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1]
    with pytest.raises(NotImplementedError, match="progressive"):
        jr.decode_jpeg_bgr(prog.tobytes())
    base = cv2.imencode(".jpg", img)[1].tobytes()
    assert np.array_equal(jr.decode_jpeg_bgr(_exif_rotated(base, 1)),
                          cv2.imdecode(np.frombuffer(base, np.uint8), 1))
    with pytest.raises(NotImplementedError, match="orientation 6"):
        jr.decode_jpeg_bgr(_exif_rotated(base, 6))
    with pytest.raises(ValueError, match="not a JPEG"):
        jr.decode_jpeg_bgr(b"\x89PNG")
    from lidarseg3d_torch.ops import cuda_build

    def no_compiler(*a, **k):
        raise RuntimeError("no C compiler (cc) found")

    monkeypatch.setattr(cuda_build, "load", no_compiler)
    with pytest.raises(RuntimeError, match="could not be built"):
        jr.decode_jpeg_bgr(base)


def _split_cfg(tree, split, infos):
    cfg = Config.fromfile(NUSC_CONFIG)
    d = copy.deepcopy(cfg.data[split].to_dict())
    d.update(root_path=tree, info_path=infos[0 if split == "train" else 1])
    return d


@pytest.fixture(scope="module")
def infos(tree, tmp_path_factory):
    return create_nuscenes_seg_infos(
        tree, cam_chans=CAM_CHANS,
        out_dir=str(tmp_path_factory.mktemp("infos")))


@pytest.mark.parametrize("split", ["val", "train"])
def test_frames_equal_jax(tree, infos, split):
    d = _split_cfg(tree, split, infos)
    ds, jds = build_dataset(copy.deepcopy(d)), jbuild_dataset(
        copy.deepcopy(d))
    assert len(ds) == len(jds) == 2
    for seed in (0, 1):
        got = ds.get_sensor_data(1, rng=np.random.default_rng(seed))
        want = jds.get_sensor_data(1, rng=np.random.default_rng(seed))
        assert set(got) == set(want), set(got) ^ set(want)
        assert got["metadata"] == want["metadata"]
        for k, w in want.items():
            if k != "metadata":
                assert got[k].dtype == w.dtype and np.array_equal(
                    got[k], w), (split, seed, k)
        assert got["images"].shape == (6, 640, 960, 3)
        assert (got["points_cuv"][:, 0] > 0).mean() > 0.3


def test_evaluation_equals_jax(tree, infos, tmp_path):
    d = _split_cfg(tree, "val", infos)
    ds, jds = build_dataset(copy.deepcopy(d)), jbuild_dataset(
        copy.deepcopy(d))
    rng = np.random.default_rng(4)
    dets = {}
    for info in ds._infos:
        gt = ds.get_anno_for_eval(info["token"])["point_sem_labels"]
        noisy = np.where(rng.random(len(gt)) < 0.3,
                         rng.integers(0, 17, len(gt)), gt)
        dets[info["token"]] = {"pred_point_sem_labels": noisy.astype(
            np.int32)}
    got, _ = ds.evaluation(dets)
    want, _ = jds.evaluation(dets)
    assert set(got["results"]) == set(want["results"])
    for k, v in want["results"].items():
        assert got["results"][k] == v or (np.isnan(v) and np.isnan(
            got["results"][k])), k
    assert 0 < got["results"]["mIoU"] < 100
    assert ds.evaluation(dets, output_dir=str(tmp_path / "t"),
                         testset=True) == (None, None)
    jds.evaluation(dets, output_dir=str(tmp_path / "j"), testset=True)
    sub = "results_folder/lidarseg/test"
    names = sorted(os.listdir(tmp_path / "t" / sub))
    assert names == sorted(os.listdir(tmp_path / "j" / sub))
    assert names == sorted(f"{i['lidar_sd_token']}_lidarseg.bin"
                           for i in ds._infos)
    for n in names:
        assert (tmp_path / "t" / sub / n).read_bytes() == (
            tmp_path / "j" / sub / n).read_bytes()


@pytest.mark.parametrize("mode", ["process", "shm"])
def test_train_batches_equal_across_worker_modes(tree, infos, mode):
    from lidarseg3d_torch.datasets import SegDataLoader

    ds = build_dataset(_split_cfg(tree, "train", infos))
    cap = Config.fromfile(NUSC_CONFIG).capacity
    out = {}
    for m in ("thread", mode):
        with SegDataLoader(ds, 1, shuffle=True, seed=2, num_workers=2,
                           worker_mode=m, on_overflow="error",
                           **cap) as loader:
            out[m] = list(loader.epoch(0))
    assert len(out[mode]) == len(out["thread"]) == 2
    for g, w in zip(out[mode], out["thread"]):
        assert set(g) == set(w)
        for k, v in w.items():
            assert g[k] == v if k == "metadata" else (
                g[k].dtype == v.dtype and np.array_equal(g[k], v)), k
