"""Both entry points on a mini cut (synthetic.write_mini_det_config) of the
published two-stage CenterPoint config
(configs/waymo/voxelnet/two_stage/waymo_centerpoint_voxelnet_two_stage_bev_5point_ft_6epoch_freeze.py:
the Waymo 3x VoxelNet frozen as its first stage, the 5-point BEV
extractor, the RoI head with DP_RATIO=0.3) over a seeded Waymo tree with
boxes and its gt database, on the CPU:

- ``tools.train`` trains one epoch of one step (the frozen first stage's
  BN statistics unchanged, every parameter finite), then ``--resume_from``
  a second, whose loaded state equals epoch_1 bit for bit;
- ``tools.test`` evaluates a checkpoint of JAX's seeded variables
  (convert.save_flax_checkpoint; spread BN statistics, so no two
  proposals tie) and its boxes equal the JAX package's ``run_det_eval``
  on the same batches with the same variables: labels and valid flags
  exact, boxes and scores within 1e-4; the frames have no velocity.

The JAX tools cannot train a detector (ROADMAP §C, reference fault 21),
so no JAX two-stage run through an entry point exists to compare the
training with; test_torch_port_two_stage.py holds the step."""

import os

import numpy as np
import pytest
import torch

from lidarseg3d_torch import synthetic
from lidarseg3d_torch.apis import train as ttrain
from lidarseg3d_torch.tools import create_data
from lidarseg3d_torch.tools import test as ttest
from lidarseg3d_torch.tools import train as train_tool

from test_torch_port_support import one_torch_thread  # noqa: F401
from test_torch_port_det_entry import _jax_side

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = ("configs/waymo/voxelnet/two_stage/"
          "waymo_centerpoint_voxelnet_two_stage_bev_5point_ft_6epoch_freeze.py")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    wy = str(tmp_path_factory.mktemp("two_stage_tree") / "waymo")
    synthetic.write_semanticwaymo_tree(
        wy, splits=("train", "val"), frames=2, top_cols=24, max_range=12.0,
        short_points=400, cams=(), boxes=9, seed=16)
    create_data.main(["waymo_gt_database", "--root", wy])
    return wy


def test_train_tool_trains_and_resumes(tree, tmp_path):
    work = str(tmp_path / "w")
    cfg = synthetic.write_mini_det_config(
        str(tmp_path / "ts.py"), os.path.join(ROOT, CONFIG), tree, work)
    args = [cfg, "--device", "cpu", "--max_steps_per_epoch", "1"]

    class First(ttrain.TrainerHook):
        def before_run(self, state, loop):
            self.stats = {k: v.clone() for k, v in
                          state.model.state_dict().items()
                          if k.startswith("single_det.")
                          and k.endswith(("running_mean", "running_var"))}

        def after_run(self, state):
            sd = state.model.state_dict()
            self.moved = [k for k, v in self.stats.items()
                          if not torch.equal(sd[k], v)]
            self.finite = all(torch.isfinite(p).all()
                              for p in state.model.parameters())

    first = First()
    train_tool.main(args + ["--total_epochs", "1"], hooks=[first])
    assert sorted(os.listdir(work)) == ["epoch_1", "latest.txt",
                                        "train.log"]
    assert first.stats and first.moved == [] and first.finite

    class Check(ttrain.TrainerHook):
        def before_run(self, state, loop):
            ckpt = torch.load(os.path.join(work, "epoch_1"),
                              map_location="cpu", weights_only=True)
            self.diff = [k for k, v in state.model.state_dict().items()
                         if not torch.equal(v, ckpt["model"][k])]
            self.start = state.step

        def after_iter(self, state, ldict, global_step):
            self.keys = set(ldict)
            self.finite = all(np.isfinite(float(v)) for v in ldict.values())

    check = Check()
    out = train_tool.main(args + ["--resume_from", "--total_epochs", "2"],
                          hooks=[check])
    assert check.diff == [] and check.start == 1 and check.finite
    assert {"rcnn_loss_cls", "rcnn_loss_reg", "loss"} <= check.keys
    assert "task0_hm_loss" not in check.keys  # the frozen first stage's
    assert out["state"].step == 2


def test_test_tool_matches_jax(tree, tmp_path):
    from lidarseg3d_torch.convert import save_flax_checkpoint
    from lidarseg3d_torch.models import build_detector
    from lidarseg3d_torch.tools.test import model_config
    from lidarseg3d_torch.utils.config import Config

    work = str(tmp_path / "work")
    cfg = synthetic.write_mini_det_config(
        str(tmp_path / "ts.py"), os.path.join(ROOT, CONFIG), tree, work)
    v, want = _jax_side(cfg)
    save_flax_checkpoint(build_detector(model_config(Config.fromfile(cfg)),
                                        device="cpu"), v["params"],
                         v["batch_stats"], work, 1)
    res = ttest.main([cfg, "--checkpoint", os.path.join(work, "epoch_1"),
                      "--device", "cpu"])
    got = res["detections"]
    assert "det_predictions.pkl" in os.listdir(work)
    assert len(got) == 2 and set(got) == set(want)
    for token, w in want.items():
        g = got[token]
        assert set(g) == set(w) == {"box3d_lidar", "scores", "label_preds",
                                    "valid"}, token
        for k in ("label_preds", "valid"):
            np.testing.assert_array_equal(g[k], np.asarray(w[k]), k)
        for k in ("box3d_lidar", "scores"):
            np.testing.assert_allclose(g[k], np.asarray(w[k]), atol=1e-4,
                                       err_msg=k)
        assert g["valid"].any() and g["valid"].shape == (500,)
