"""The port's single-frame tools and utilities, on the CPU:

- ``tools.single_inference`` on one scan of a seeded SemanticKITTI tree
  through the published SDSeg3D config cut to a mini model: its labels
  equal ``tools.test``'s for that scan;
- ``tools.simple_inference_waymo`` on one converted frame pkl of a seeded
  Waymo tree through the published two-stage config cut to a mini model
  (whose reader is its first stage's): its boxes equal ``tools.test``'s
  for that frame, and ``--visual`` writes a PNG with the points and the
  boxes' outlines;
- ``tools.visual``: the same pixels as the JAX tool's PNG (cv2 on this
  machine);
- ``tools.instance_preprocess``: the same instance library as the JAX
  package's ``save_instance`` on the same sequence;
- ``utils.flops``: ``count_params`` equals the JAX package's on the same
  variables; ``count_flops`` counts a sparse conv's 2 * hits * Cin * Cout
  per tap (hits counted here by brute force over the coordinates), which
  the flop counter cannot see in a kernel;
- ``utils.log.create_logger``: rank 0 logs to stdout and its file, other
  ranks log errors only and write no file."""

import importlib.util
import logging
import os
import pickle

import numpy as np
import pytest
import torch

from lidarseg3d_torch import synthetic
from lidarseg3d_torch.apis import train as tr
from lidarseg3d_torch.models import build_detector
from lidarseg3d_torch.tools import test as test_tool
from lidarseg3d_torch.utils.config import Config

from test_torch_port_support import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SDSEG = "configs/semantickitti/SDSeg3D/semkitti_transVFE_unetscn3d_batchloss_e10.py"
TWO_STAGE = ("configs/waymo/voxelnet/two_stage/"
             "waymo_centerpoint_voxelnet_two_stage_bev_5point_ft_6epoch_freeze.py")


@pytest.fixture(scope="module")
def kitti(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("frame_tools") / "sequences")
    synthetic.write_semantickitti_tree(root, sequences=("00", "08"),
                                       frames=2, points=(1000, 1400),
                                       seed=41, image_hw=(64, 128),
                                       max_range=6.0)
    return root


def _checkpoint(cfg, work, seed):
    model = build_detector(test_tool.model_config(cfg), device="cpu",
                           seed=seed)
    tr.save_checkpoint(work, tr.TrainState(0, model, None, None), 1)


def test_single_inference_equals_tools_test(kitti, tmp_path):
    from lidarseg3d_torch.tools import single_inference

    path = synthetic.write_mini_segnet_config(
        str(tmp_path / "sdseg.py"), os.path.join(ROOT, SDSEG), kitti,
        str(tmp_path / "work"))
    cfg = Config.fromfile(path)
    work = str(tmp_path / "ckpt")
    _checkpoint(cfg, work, seed=2)
    want = test_tool.main([path, "--checkpoint", work, "--device", "cpu"])
    token, pred = sorted(want["detections"].items())[0]
    scan = next(os.path.join(dp, f) for dp, _, fs in os.walk(kitti)
                for f in fs if f.endswith(".bin")
                and os.path.join(dp, f).endswith(token))
    out = str(tmp_path / "labels.npy")
    labels = single_inference.main([path, "--checkpoint", work, "--scan",
                                    scan, "--out", out, "--device", "cpu"])
    np.testing.assert_array_equal(labels, pred["pred_point_sem_labels"])
    np.testing.assert_array_equal(np.load(out), labels)
    assert labels.dtype == np.int32


def test_simple_inference_waymo_equals_tools_test(tmp_path):
    from lidarseg3d_torch.datasets.pipelines.png import read_png_bgr
    from lidarseg3d_torch.tools import simple_inference_waymo as siw

    tree = str(tmp_path / "waymo")
    paths = synthetic.write_semanticwaymo_tree(
        tree, splits=("val",), frames=1, top_cols=24, max_range=12.0,
        short_points=400, cams=(), boxes=6, seed=43)
    path = synthetic.write_mini_det_config(
        str(tmp_path / "ts.py"), os.path.join(ROOT, TWO_STAGE), tree,
        str(tmp_path / "work"))
    cfg = Config.fromfile(path)
    assert "reader" not in cfg.model and siw.reader_width(cfg.model) == 5
    work = str(tmp_path / "ckpt")
    _checkpoint(cfg, work, seed=3)
    want = test_tool.main([path, "--checkpoint", work, "--device", "cpu"])
    (token, w), = want["detections"].items()
    with open(paths["val"], "rb") as f:
        frame = pickle.load(f)[0]["path"]
    png = str(tmp_path / "bev.png")
    got = siw.main([path, "--checkpoint", work, "--frame", frame, "--out",
                    str(tmp_path / "dets.pkl"), "--visual", png,
                    "--device", "cpu"])
    v = w["valid"]
    assert v.any()
    np.testing.assert_array_equal(got["label_preds"], w["label_preds"][v])
    np.testing.assert_array_equal(got["box3d_lidar"], w["box3d_lidar"][v])
    np.testing.assert_array_equal(got["scores"], w["scores"][v])
    img = read_png_bgr(png)
    assert img.shape == (256, 256, 3)
    assert (img == (128, 128, 128)).all(-1).any()
    assert (img == (0, 0, 255)).all(-1).any()


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_visual_equals_jax_tool(tmp_path, monkeypatch):
    import cv2

    from lidarseg3d_torch.tools import visual

    rng = np.random.default_rng(44)
    pts = rng.uniform(-70, 70, (5000, 4)).astype(np.float32)
    scan, lab = str(tmp_path / "scan.bin"), str(tmp_path / "labels.npy")
    pts.tofile(scan)
    np.save(lab, rng.integers(0, 20, 5000))
    args = ["--scan", scan, "--labels", lab, "--extent", "50"]
    visual.main(args + ["--out", str(tmp_path / "port.png")])
    monkeypatch.setattr("sys.argv", ["visual.py", *args, "--out",
                                     str(tmp_path / "jax.png")])
    _jax_tool("visual").main()
    a = cv2.imread(str(tmp_path / "port.png"))
    b = cv2.imread(str(tmp_path / "jax.png"))
    assert a.shape == b.shape == (666, 666, 3)
    np.testing.assert_array_equal(a, b)


def test_instance_preprocess_equals_jax(tmp_path):
    from lidarseg3d_tpu.datasets.semantickitti.dataset import (
        SemanticKITTIDataset as JDataset)
    from lidarseg3d_torch.tools import instance_preprocess

    root = str(tmp_path / "sequences")  # a scan in each train sequence
    synthetic.write_semantickitti_tree(
        root, sequences=tuple(instance_preprocess.TRAIN_SEQ), frames=1,
        points=(1000, 1400), seed=46, image_hw=(64, 128), max_range=6.0)
    got = instance_preprocess.main([
        "--data_path", root, "--out_path", str(tmp_path / "port"),
        "--min_points", "5"])
    want = JDataset(root_path=root, sequences=instance_preprocess.TRAIN_SEQ,
                    test_mode=False).save_instance(str(tmp_path / "jax"),
                                                   min_points=5)
    with open(got, "rb") as f:
        a = pickle.load(f)
    with open(want, "rb") as f:
        b = pickle.load(f)
    assert a.keys() == b.keys() and sum(len(v) for v in a.values()) > 0
    for cls in a:
        assert len(a[cls]) == len(b[cls])
        for pa, pb in zip(a[cls], b[cls]):
            assert os.path.relpath(pa, tmp_path / "port") == \
                os.path.relpath(pb, tmp_path / "jax")
            assert open(pa, "rb").read() == open(pb, "rb").read()


def test_count_params_equals_jax():
    import copy

    import jax

    from lidarseg3d_tpu.models import build_detector as jbuild
    from lidarseg3d_tpu.utils.flops import count_params as jcount
    from lidarseg3d_torch.utils.flops import count_params

    from test_torch_port_det_support import det_batch, grid, voxelnet_cfg
    from _torch_port_helpers import init_shapes

    cfg, pcr, vsz, tids = voxelnet_cfg()
    b = det_batch(1, pcr, vsz, tids)
    ex = {k: jax.numpy.asarray(b[k]) for k in ("voxels", "coordinates",
                                               "num_points", "num_voxels")}
    shapes = init_shapes(jbuild(copy.deepcopy(cfg)),
                         dict(ex, input_shape=grid(pcr, vsz)), train=False)
    tm = build_detector(dict(copy.deepcopy(cfg), input_shape=grid(pcr, vsz)),
                        device="cpu")
    assert count_params(tm) == jcount(shapes["params"]) > 10 ** 6
    assert count_params(dict(tm.named_parameters())) == count_params(tm)


def test_count_flops_counts_the_sparse_convs():
    from lidarseg3d_torch.ops import rulebook_conv as rc
    from lidarseg3d_torch.ops import sparse as sp
    from lidarseg3d_torch.utils.flops import count_flops

    rng = np.random.default_rng(45)
    shape, V, cin, cout = (6, 10, 12), 300, 8, 16
    cells = rng.choice(np.prod(shape), size=(2, 250), replace=False)
    coords = np.zeros((2, V, 3), np.int32)
    coords[:, :250] = np.stack(np.unravel_index(cells, shape), -1)
    nums = np.array([250, 180])
    s = sp.build_structure(torch.from_numpy(coords),
                           torch.from_numpy(nums), shape)
    rb = sp.build_subm_rulebook(s)
    feats = torch.rand(2, V, cin)
    w = torch.rand(27, cin, cout)
    launches = rc.rulebook_conv.launches
    out = count_flops(lambda: sp.subm_conv(sp.SparseTensor(s, feats), w, rb))
    assert rc.rulebook_conv.launches == launches  # restored, CPU: none
    hits = 0
    for b in range(2):
        act = {tuple(c) for c in coords[b, :nums[b]]}
        for c in act:
            hits += sum((c[0] + dz, c[1] + dy, c[2] + dx) in act
                        for dz in (-1, 0, 1) for dy in (-1, 0, 1)
                        for dx in (-1, 0, 1))
    assert out["rulebook_conv_flops"] == 2 * hits * cin * cout
    assert out["dense_flops"] == 0
    assert out["flops"] == out["rulebook_conv_flops"]


def test_create_logger_is_rank_aware(tmp_path, capsys):
    from lidarseg3d_torch.utils.log import create_logger

    f0 = tmp_path / "rank0.log"
    lg = create_logger(str(f0), rank=0, name="port_log_test_0")
    lg.info("hello")
    assert lg.level == logging.INFO and "hello" in f0.read_text()
    assert create_logger(name="port_log_test_0") is lg
    f1 = tmp_path / "rank1.log"
    lg1 = create_logger(str(f1), rank=1, name="port_log_test_1")
    lg1.info("quiet")
    lg1.error("loud")
    assert lg1.level == logging.ERROR and not f1.exists()
    out = capsys.readouterr().out
    assert "hello" in out and "loud" in out and "quiet" not in out
