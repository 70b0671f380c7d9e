"""lidarseg3d_torch/tools/synthetic_e2e.py, the train -> checkpoint ->
eval (+ TTA) closure, against the JAX package's tools/synthetic_e2e.py:

- ``write_fixture`` writes JAX's tree at the same seed: every .bin,
  .label and calib.txt byte for byte, and PNGs whose decoded pixels
  (cv2, in this test only) equal those of JAX's cv2-written PNGs;
- a cut of the whole closure on the CPU: 6 frames and 12 epochs at B=2
  (36 steps of the mini MSeg3D config through tools.train, then
  tools.test with and without --tta), with --min-miou 0.05. A model that
  predicts one class for every point scores at most 0.0220 on these
  frames (computed below with the dataset's own evaluation, every class
  tried), so the cut fails if training does nothing; the tool's own TTA
  check (TTA mIoU >= plain - 0.02) holds too. The bar is the JAX
  package's own tools/synthetic_e2e.py at this cut, 0.1086, less the
  spread of the port's readings over four seeds of its initialization,
  0.0761-0.1350 (0.0761 at build_detector's seed 0, this test's; ``python
  tests/test_torch_port_synthetic_e2e.py`` prints them): at 36 steps the
  reading is mostly the draw's. The full 40-frame tree runs on
  the card (``python -m lidarseg3d_torch.tools.synthetic_e2e --epochs
  40``; chip_smoke.py phase 3w runs this cut there);
- the tool keeps JAX's defaults, but its device is cuda."""

import os
import sys

import numpy as np
import pytest

from lidarseg3d_torch.tools import synthetic_e2e

from test_torch_port_support import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUT = dict(frames=6, epochs=12, min_miou=0.05)


def _jax_tool():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import synthetic_e2e as jtool
    finally:
        sys.path.pop(0)
    return jtool


def test_fixture_equals_jax(tmp_path):
    import cv2

    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "port")
    _jax_tool().write_fixture(jroot, 3)
    synthetic_e2e.write_fixture(troot, 3)
    files = sorted(os.path.relpath(os.path.join(dp, f), jroot)
                   for dp, _, fs in os.walk(jroot) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(dp, f), troot)
                           for dp, _, fs in os.walk(troot) for f in fs)
    assert len(files) == 10
    for f in files:
        a, b = os.path.join(jroot, f), os.path.join(troot, f)
        if f.endswith(".png"):
            want = cv2.imread(a, cv2.IMREAD_UNCHANGED)
            got = cv2.imread(b, cv2.IMREAD_UNCHANGED)
            assert want.shape == (64, 128, 3)
            np.testing.assert_array_equal(got, want, err_msg=f)
        else:
            assert open(a, "rb").read() == open(b, "rb").read(), f


def _one_class_miou(cfg_path):
    """The best mIoU of a model that predicts one class everywhere, by the
    dataset's evaluation over the fixture's frames."""
    from lidarseg3d_torch.datasets import build_dataset
    from lidarseg3d_torch.utils.config import Config

    ds = build_dataset(Config.fromfile(cfg_path).data.val.to_dict())
    tokens = [ds.get_sensor_data(i)["metadata"]["token"]
              for i in range(len(ds))]
    best = 0.0
    for c in range(1, 9):
        dets = {t: {"pred_point_sem_labels": np.full(
            len(ds.get_anno_for_eval(t)["point_sem_labels"]), c, np.int32)}
            for t in tokens}
        res, _ = ds.evaluation(dets)
        best = max(best, res["results"]["mIoU"] / 100.0)
    return best


def test_closure_cut_on_the_cpu(tmp_path):
    out = synthetic_e2e.main([
        "--device", "cpu", "--frames", str(CUT["frames"]), "--epochs",
        str(CUT["epochs"]), "--min-miou", str(CUT["min_miou"]), "--root",
        str(tmp_path)])
    one_class = _one_class_miou(str(tmp_path / "cfg.py"))
    assert 0.0 < one_class <= 0.0220 < CUT["min_miou"] / 2
    assert out["miou"] >= CUT["min_miou"]
    assert out["miou_tta"] >= out["miou"] - synthetic_e2e.TTA_SLACK
    work = tmp_path / "work"
    assert (work / f"epoch_{CUT['epochs']}").exists()
    assert f"saved checkpoint epoch_{CUT['epochs']}" in (
        work / "train.log").read_text()


def test_defaults_are_jax_but_the_device():
    args = synthetic_e2e.parse_args([])
    assert (args.frames, args.epochs, args.lr, args.min_miou,
            args.batch_size) == (40, 20, 0.01, 0.85, 2)
    assert args.device == "cuda"
    with pytest.raises(SystemExit):
        synthetic_e2e.parse_args(["--device", "tpu"])


def _cut_at_init_seed(seed, root):
    """The cut with the model's initial weights drawn from ``seed`` (the
    build_detector's default is 0; the data order stays the tool's)."""
    import torch

    from lidarseg3d_torch.models import builder

    init = builder.init_parameters
    builder.init_parameters = lambda model, gen: init(
        model, torch.Generator().manual_seed(seed))
    try:
        return synthetic_e2e.main([
            "--device", "cpu", "--frames", str(CUT["frames"]), "--epochs",
            str(CUT["epochs"]), "--min-miou", "0", "--root", root])
    finally:
        builder.init_parameters = init


if __name__ == "__main__":
    import tempfile

    import torch

    torch.set_num_threads(1)
    for seed in range(4):
        out = _cut_at_init_seed(seed, tempfile.mkdtemp())
        print(f"init seed {seed}: mIoU {out['miou']:.4f}, TTA "
              f"{out['miou_tta']:.4f}", flush=True)
