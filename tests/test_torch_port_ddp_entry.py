"""Both entry points on 2 gloo ranks (CPU) over the mini MSeg3D config
(configs/tests/mini_semkitti_mseg3d.py with frozen_stages=3, as
``synthetic.write_eval_config`` writes it) on a seeded tree:

- ``tools.train`` started by its ``--dist_*`` flags, B=2 a rank on four
  frames (one step an epoch), with ``--autoscale-lr`` (2 cards / 8): one
  checkpoint file an epoch and ``latest.txt``, written by rank 0, and
  ``train.log`` from rank 0 alone; the two ranks end with bit-identical
  states; one epoch, then a resume for the second, ends bit for bit where
  two epochs straight end;
- ``tools.test`` in a group whose ranks read torchrun's ``RANK`` /
  ``WORLD_SIZE`` / ``LOCAL_RANK`` over a ``file://`` rendezvous (no port
  is chosen before it is bound: test_torch_port_dist.py holds
  ``MASTER_ADDR`` / ``MASTER_PORT``'s URL), over three frames (odd:
  the sampler pads rank 1's shard with frame 0) with a checkpoint of
  seeded random weights and BN statistics (so the labels spread over the
  classes): the ranks' detections split the frames between them, each
  frame once, and their labels equal the one-process run's; every rank's
  mIoU (finite) and per-class IoUs equal the one-process run's (each frame
  counted once); so does ``run_eval_device_hist``'s histogram, summed
  over the ranks' shards; on the test split rank 0 writes every frame's
  label file, equal to the one-process run's."""

import glob
import os

import numpy as np
import pytest
import torch

from lidarseg3d_torch.synthetic import (write_eval_config,
                                        write_semantickitti_tree)
from lidarseg3d_torch.tools import test as eval_tool

from _torch_ddp import eval_tool_rank, rendezvous, run_ranks, train_tool_rank
from test_torch_port_support import MINI_CONFIG, one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ddp_entry")
    train_root = str(tmp / "train" / "sequences")
    write_semantickitti_tree(train_root, ("00",), frames=4,
                             points=(1200, 1500), seed=12,
                             image_hw=(64, 128), max_range=6.0)
    val_root = str(tmp / "val" / "sequences")
    write_semantickitti_tree(val_root, ("00",), frames=3,
                             points=(1200, 1500), seed=13,
                             image_hw=(64, 128), max_range=6.0)
    return dict(tmp=tmp,
                train=write_eval_config(str(tmp / "train.py"), MINI_CONFIG,
                                        train_root),
                val=write_eval_config(str(tmp / "val.py"), MINI_CONFIG,
                                      val_root))


def _train(setup, name, extra):
    work = setup["tmp"] / name
    argv = [setup["train"], "--device", "cpu", "--work_dir", str(work),
            "--autoscale-lr", "--dist_coordinator",
            rendezvous(setup["tmp"] / f"{name}_ranks")] + extra
    return work, run_ranks(train_tool_rank, 2, setup["tmp"] / f"{name}_ranks",
                           argv, start=False)


@pytest.fixture(scope="module")
def trained(setup):
    work, straight = _train(setup, "straight", ["--total_epochs", "2"])
    _, first = _train(setup, "resumed", ["--total_epochs", "1"])
    resumed_work, resumed = _train(setup, "resumed", [
        "--total_epochs", "2", "--resume_from"])
    return dict(work=work, straight=straight, first=first,
                resumed=resumed, resumed_work=resumed_work)


def test_train_writes_one_checkpoint_an_epoch_from_rank_0(trained):
    work = trained["work"]
    assert sorted(os.listdir(work)) == ["epoch_1", "epoch_2", "latest.txt",
                                        "train.log"]
    log = open(work / "train.log").read()
    assert "processes: 2" in log
    assert "autoscale-lr: lr_max *= 0.250 (2 cards)" in log
    assert log.count("Epoch [1/2][1/1]") == 1  # rank 0 alone logs
    saved = torch.load(work / "epoch_2", weights_only=True)
    for k, v in trained["straight"][0].items():
        assert torch.equal(saved["model"][k], v), k


def test_train_ranks_stay_bit_identical(trained):
    for run in ("straight", "first", "resumed"):
        a, b = trained[run]
        for k in a:
            assert torch.equal(a[k], b[k]), (run, k)


def test_train_resume_continues_bit_for_bit(trained):
    a, b = trained["straight"][0], trained["resumed"][0]
    moved = 0
    for k in a:
        assert torch.equal(a[k], b[k]), k
        moved += not torch.equal(a[k], trained["first"][0][k])
    assert moved > 0


def _random_checkpoint(cfg_path, work):
    """A checkpoint of the config's model with seeded random weights and
    BN statistics."""
    from lidarseg3d_torch.apis.train import TrainState, save_checkpoint
    from lidarseg3d_torch.models import build_detector
    from lidarseg3d_torch.utils.config import Config

    model = build_detector(Config.fromfile(cfg_path).model.to_dict(),
                           device="cpu", seed=5)
    gen = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for k, v in model.state_dict().items():
            if k.endswith("running_var"):
                v.copy_(0.5 + 1.5 * torch.rand(v.shape, generator=gen))
            elif v.is_floating_point():
                v.add_(0.2 * torch.randn(v.shape, generator=gen))
    save_checkpoint(str(work), TrainState(0, model, None, None), 1)
    return str(work)


def _labels(test_dir):
    files = sorted(glob.glob(os.path.join(
        test_dir, "out", "SemKITTI_test", "sequences", "*", "predictions",
        "*.label")))
    return {os.path.relpath(f, test_dir): np.fromfile(f, np.uint32)
            for f in files}


def test_eval_on_two_ranks_counts_each_frame_once(setup):
    from lidarseg3d_torch.apis.eval import run_eval_device_hist
    from lidarseg3d_torch.datasets import SegDataLoader, build_dataset
    from lidarseg3d_torch.utils.config import Config

    work = _random_checkpoint(setup["val"], setup["tmp"] / "random")
    argv = [setup["val"], "--checkpoint", work, "--device", "cpu"]
    one = eval_tool.main(argv)
    assert np.isfinite(one["results"]["results"]["mIoU"])
    cfg = Config.fromfile(setup["val"])
    ds = build_dataset(cfg.data.val.to_dict())
    with SegDataLoader(ds, 1, shuffle=False, drop_last=False,
                       num_workers=1, **cfg.capacity) as loader:
        _, _, one_hist = run_eval_device_hist(
            one["state"].model, one["state"], loader,
            eval_tool.input_shape_of(cfg), ds, cfg.num_class)
    one_dir = str(setup["tmp"] / "test_one")
    eval_tool.main(argv + ["--testset", "--work_dir", one_dir])
    want_files = _labels(one_dir)
    assert len(want_files) == 3
    test_dir = str(setup["tmp"] / "test_ranks")
    ranks = run_ranks(eval_tool_rank, 2, setup["tmp"] / "eval_ranks", argv,
                      rendezvous(setup["tmp"] / "eval_ranks"), test_dir,
                      start=False)
    got_files = _labels(test_dir)
    assert got_files.keys() == want_files.keys()
    for k, v in want_files.items():
        np.testing.assert_array_equal(got_files[k], v)
    for r in ranks:
        np.testing.assert_array_equal(r["hist"], one_hist)
    tokens = [set(r["detections"]) for r in ranks]
    assert not tokens[0] & tokens[1]
    assert tokens[0] | tokens[1] == set(one["detections"])
    assert len(one["detections"]) == 3 and len(tokens[0]) == 2
    for r in ranks:
        for tok, det in r["detections"].items():
            np.testing.assert_array_equal(
                det["pred_point_sem_labels"],
                one["detections"][tok]["pred_point_sem_labels"])
        assert r["results"]["results"].keys() == one["results"][
            "results"].keys()
        for k, v in one["results"]["results"].items():
            assert r["results"]["results"][k] == v or (
                np.isnan(v) and np.isnan(r["results"]["results"][k])), k
