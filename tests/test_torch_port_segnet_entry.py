"""The six published SegNet configs through the port's entry points on the
CPU, each cut to a mini model by ``synthetic.write_mini_segnet_config``
(their pipelines, datasets, optimizer and schedule stay the published
ones) over seeded SemanticKITTI and nuScenes trees:

- SDSeg3D's SemanticKITTI and nuScenes configs and their ``_tta``
  variants, and the MSeg3D papers' lidar-only baselines: each evaluates
  through ``python -m lidarseg3d_torch.tools.test`` (the ``_tta`` ones
  with ``--tta``) with every val point labelled, and trains one step
  through ``python -m lidarseg3d_torch.tools.train``;
- ``tools.train --validate`` on the SDSeg3D SemanticKITTI config, then a
  resume: the resumed state equals the checkpoint exactly and starts at
  the saved global step;
- a train step of TransVFE's SegNet launches 36 forward and 36 dX convs
  (the input conv's features come from TransVFE and need a gradient), a
  lidar baseline's 36 + 35 (ImprovedMeanVFE has no parameters, so the
  input conv launches no dX), counted at the conv wrapper."""

import os

import numpy as np
import pytest
import torch

from lidarseg3d_torch.apis import train as tr
from lidarseg3d_torch.datasets import build_dataset
from lidarseg3d_torch.datasets.nuscenes.common import (
    create_nuscenes_seg_infos)
from lidarseg3d_torch.models import build_detector
from lidarseg3d_torch.ops import rulebook_conv as rc
from lidarseg3d_torch import synthetic as syn
from lidarseg3d_torch.solver.optim import build_one_cycle_optimizer
from lidarseg3d_torch.synthetic import (write_mini_segnet_config,
                                        write_semantickitti_tree,
                                        write_semnusc_tree)
from lidarseg3d_torch.tools import test as test_tool
from lidarseg3d_torch.tools import train as train_tool
from lidarseg3d_torch.utils.config import Config

from test_torch_port_support import MINI_CONFIG, NUSC_CHANS
from test_torch_port_support import one_torch_thread  # noqa: F401

CFG_DIR = MINI_CONFIG.rsplit("/configs/", 1)[0] + "/configs/"
SEGNET_CONFIGS = {
    "sdseg_kitti": "semantickitti/SDSeg3D/"
                   "semkitti_transVFE_unetscn3d_batchloss_e10.py",
    "sdseg_kitti_tta": "semantickitti/SDSeg3D/"
                       "semkitti_transVFE_unetscn3d_batchloss_e10_tta.py",
    "baseline_kitti": "semantickitti/MSeg3D/"
                      "semkitti_avgvfe_unetscn3d_lidarbaseline_lr1en2_e12.py",
    "sdseg_nusc": "semanticnusc/SDSeg3D/"
                  "semnusc_transvfe_unetscn3d_batchloss_e48.py",
    "sdseg_nusc_tta": "semanticnusc/SDSeg3D/"
                      "semnusc_transvfe_unetscn3d_batchloss_e48_tta.py",
    "baseline_nusc": "semanticnusc/MSeg3D/"
                     "semnusc_avgvfe_unetscn3d_lidarbaseline_lr1en2_e12.py",
}


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("segnet_entry")
    kitti = str(tmp / "sequences")
    write_semantickitti_tree(kitti, sequences=("00", "08"), frames=2,
                             points=(1000, 1400), seed=21,
                             image_hw=(64, 128), max_range=6.0)
    nusc = str(tmp / "nusc")
    write_semnusc_tree(nusc, scenes=("scene-0001", "scene-0003"), samples=2,
                       points=(1500, 2000), max_range=12.0, cams=NUSC_CHANS,
                       seed=22)
    create_nuscenes_seg_infos(nusc, cam_chans=NUSC_CHANS)
    return dict(kitti=kitti, nusc=nusc, tmp=tmp)


def mini(trees, name, tmp_path):
    nusc = "nusc" in name
    return write_mini_segnet_config(
        str(tmp_path / f"{name}.py"), CFG_DIR + SEGNET_CONFIGS[name],
        trees["nusc" if nusc else "kitti"], str(tmp_path / "work"),
        cam_chans=NUSC_CHANS if nusc else None)


@pytest.mark.parametrize("name", sorted(SEGNET_CONFIGS))
def test_published_config_evaluates_and_trains(trees, name, tmp_path):
    path = mini(trees, name, tmp_path)
    cfg = Config.fromfile(path)
    assert cfg.model.type == "SegNet"
    ckpt = str(tmp_path / "ckpt")
    tr.save_checkpoint(ckpt, tr.TrainState(0, build_detector(
        cfg.model.to_dict(), device="cpu", seed=1), None, None), 1)
    tta = ["--tta"] if name.endswith("_tta") else []
    out = test_tool.main([path, "--checkpoint", ckpt, "--device", "cpu"]
                         + tta)
    ds = build_dataset(cfg.data.val.to_dict())
    assert len(out["detections"]) == len(ds) == 2
    for token, pred in out["detections"].items():
        labels = pred["pred_point_sem_labels"]
        n = len(ds.get_anno_for_eval(token)["point_sem_labels"])
        assert labels.shape == (n,) and labels.min() >= 0 \
            and labels.max() < cfg.num_class
    assert np.isfinite(out["results"]["results"]["mIoU"])

    losses = []

    class Record(tr.TrainerHook):
        def after_iter(self, state, ldict, global_step):
            losses.append({k: float(v) for k, v in ldict.items()})

    res = train_tool.main([path, "--device", "cpu", "--total_epochs", "1",
                           "--max_steps_per_epoch", "1"], hooks=[Record()])
    assert len(losses) == 1 and res["state"].step == 1
    assert set(losses[0]) == {"loss", "grad_norm", "conv_ce_loss",
                              "conv_lovasz_loss", "out_ce_loss",
                              "out_lovasz_loss"}
    assert all(np.isfinite(v) for v in losses[0].values())
    assert os.path.isfile(os.path.join(res["work_dir"], "epoch_1"))


def test_train_validates_and_resumes(trees, tmp_path, capsys):
    path = mini(trees, "sdseg_kitti", tmp_path)
    work = str(tmp_path / "w")
    args = [path, "--work_dir", work, "--device", "cpu",
            "--max_steps_per_epoch", "1"]
    train_tool.main(args + ["--total_epochs", "2", "--validate"])
    assert "mIoU" in capsys.readouterr().out
    assert sorted(os.listdir(work)) == ["epoch_1", "epoch_2", "latest.txt",
                                        "train.log"]

    class Check(tr.TrainerHook):
        def before_run(self, state, loop):
            ckpt = torch.load(os.path.join(work, "epoch_2"),
                              map_location="cpu", weights_only=True)
            self.diff = [k for k, v in state.model.state_dict().items()
                         if not torch.equal(v, ckpt["model"][k])]
            self.diff += [f"mu[{i}]" for i, (a, b) in enumerate(zip(
                state.opt_state.mu, ckpt["optimizer"]["mu"], strict=True))
                if not torch.equal(a, b)]
            self.start = (state.step, state.opt_state.count)

        def after_iter(self, state, ldict, global_step):
            self.first = getattr(self, "first", global_step)

    check = Check()
    out = train_tool.main(args + ["--resume_from", "--total_epochs", "3"],
                          hooks=[check])
    assert check.diff == [] and check.start == (2, 2) and check.first == 2
    assert out["state"].step == 3


@pytest.mark.parametrize("reader,convs", [("transvfe", 72),
                                          ("improved_mean", 71)])
def test_train_step_conv_count(reader, convs, monkeypatch):
    pcr, vsz = [-6.0, -6.0, -2.0, 6.0, 6.0, 2.0], [0.3, 0.3, 0.4]
    cfg = syn.segnet_model_cfg(ratio=1, pcr=pcr, vsz=vsz, reader=reader)
    if reader == "transvfe":
        cfg["reader"].update(num_embed=16, num_layers=1)
    model = build_detector(cfg, device="cpu")
    opt, _ = build_one_cycle_optimizer(
        dict(type="adam", wd=0.01), dict(lr_max=1e-3, moms=(0.95, 0.85),
                                         div_factor=10.0, pct_start=0.4),
        10, grad_clip=35.0)
    state = tr.create_train_state(model, opt)
    step = tr.make_train_step(model, opt, syn.grid_shape(pcr, vsz))
    batch = syn.synthetic_batch(2, 1024, 1024, seed=2, with_labels=True,
                            pcr=pcr, vsz=vsz)
    calls = {"conv": 0, "dw": 0}
    real_conv, real_dw = rc.rulebook_conv, rc.rulebook_conv_dw

    def conv(*a, **k):
        calls["conv"] += 1
        return real_conv(*a, **k)

    def dw(*a, **k):
        calls["dw"] += 1
        return real_dw(*a, **k)

    monkeypatch.setattr(rc, "rulebook_conv", conv)
    monkeypatch.setattr(rc, "rulebook_conv_dw", dw)
    step(state, tr.example_to_device(batch, "cpu"))
    assert calls == {"conv": convs, "dw": 36}
