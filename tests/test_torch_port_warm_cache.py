"""lidarseg3d_torch/tools/warm_cache.py against the JAX package's
tools/warm_cache.py:

- for every published config under configs/ (the test configs aside)
  that has a voxel generator, ``synthetic_example`` at B=1 gives JAX's
  batch: the same keys, shapes and dtypes, and the same values byte for
  byte (the port's synthetic builders are copies of __graft_entry__'s,
  with the same seeded draws), and the grid the tool steps on is JAX's
  ``input_shape`` arithmetic; the three SegPolarNet configs, which have
  no voxel generator, fail in JAX's and raise in the port's, with the
  reason;
- the tool on configs/tests/mini_semkitti_mseg3d.py with --device cpu
  (the host C helpers built, the kernels' plain versions): one train step
  (a finite loss) and one eval step at the config's samples_per_gpu,
  their seconds printed (peak memory: not measured on the CPU);
  --train_only and --eval_only run one step each; a detection config is
  refused before any step, where JAX's tool fails in both (its reader
  asserts 5 point features, the example has 4; its loss reads the
  det_targets the example lacks)."""

import glob
import os
import sys

import numpy as np
import pytest

from lidarseg3d_tpu.utils.config import Config as JConfig
from lidarseg3d_torch.tools import warm_cache
from lidarseg3d_torch.tools.test import input_shape_of
from lidarseg3d_torch.utils.config import Config

from test_torch_port_support import MINI_CONFIG, one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, ROOT) for p in glob.glob(
    os.path.join(ROOT, "configs", "**", "*.py"), recursive=True)
    if os.sep + "tests" + os.sep not in p)


def _jax_tool():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import warm_cache as jtool
    finally:
        sys.path.pop(0)
    return jtool


def test_every_published_config_is_listed():
    assert len(CONFIGS) == 19


@pytest.mark.parametrize("config", CONFIGS)
def test_synthetic_example_equals_jax(config):
    path = os.path.join(ROOT, config)
    jcfg, tcfg = JConfig.fromfile(path), Config.fromfile(path)
    if "voxel_generator" not in jcfg:
        assert jcfg.model["type"] == "SegPolarNet"
        with pytest.raises(AttributeError, match="voxel_generator"):
            _jax_tool().synthetic_example(jcfg, 1)
        with pytest.raises(ValueError, match="no voxel_generator"):
            warm_cache.synthetic_example(tcfg, 1)
        return
    want = _jax_tool().synthetic_example(jcfg, 1)
    got = warm_cache.synthetic_example(tcfg, 1)
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k
    cap = jcfg.get("capacity", {})
    assert want["voxels"].shape[1] == cap.get("max_voxels", 160000)
    # the JAX tool's input_shape arithmetic
    gs = np.asarray(jcfg.voxel_generator["range"], np.float32)
    vs = np.asarray(jcfg.voxel_generator["voxel_size"], np.float32)
    grid = np.round((gs[3:] - gs[:3]) / vs).astype(int)
    assert input_shape_of(tcfg) == (int(grid[2]) + 1, int(grid[1]),
                                    int(grid[0]))


def test_tool_runs_the_mini_config_on_the_cpu(capsys):
    out = warm_cache.main([MINI_CONFIG, "--device", "cpu"])
    text = capsys.readouterr().out
    assert out["batch_size"] == 2
    assert np.isfinite(out["train"]["loss"])
    for step in ("train", "eval"):
        assert out[step]["seconds"] > 0 and out[step]["peak_bytes"] is None
        assert f"{step} step ran in" in text
    assert "peak device memory not measured (cpu)" in text
    assert "batch: B=2, voxels (2, 1536, 5, 4)" in text
    one = warm_cache.main([MINI_CONFIG, "--device", "cpu", "--batch_size",
                           "1", "--train_only"])
    assert "train" in one and "eval" not in one and one["batch_size"] == 1
    one = warm_cache.main([MINI_CONFIG, "--device", "cpu", "--eval_only"])
    assert "eval" in one and "train" not in one


def test_tool_refuses_a_detection_config():
    import jax
    from lidarseg3d_tpu.models import build_detector as jax_build
    from lidarseg3d_tpu.models.readers.voxel_encoders import (
        MeanVoxelFeatureExtractor)

    cfg = os.path.join(ROOT, "configs/waymo/voxelnet/"
                       "waymo_centerpoint_voxelnet_3x.py")
    # JAX's tool fails there in both steps: its reader asserts the
    # config's 5 point features where the synthetic example has 4, and
    # its train step's loss reads the det_targets the example lacks
    jcfg = JConfig.fromfile(cfg)
    ex = _jax_tool().synthetic_example(jcfg, 1)
    assert jcfg.model["reader"]["num_input_features"] == 5
    reader = MeanVoxelFeatureExtractor(num_input_features=5)
    with pytest.raises(AssertionError):
        reader.init(jax.random.PRNGKey(0), ex["voxels"], ex["num_points"])
    assert "det_targets" not in ex
    jmodel = jax_build(jcfg.model.to_dict(), train_cfg=jcfg.get("train_cfg"),
                       test_cfg=jcfg.get("test_cfg"))
    with pytest.raises(KeyError, match="det_targets"):
        jmodel.loss({}, ex)
    for only in ([], ["--train_only"], ["--eval_only"]):
        with pytest.raises(ValueError, match="no box targets"):
            warm_cache.main([cfg, "--device", "cpu"] + only)
