"""The port's checkpoints and its evaluation entry point.

- ``save_checkpoint`` -> ``load_checkpoint`` round-trips every tensor of
  the model, the optimizer state, the step and the dropout generator
  bit-exactly; ``partial=True`` restores the weights, BN statistics and
  step only.
- A JAX train state of configs/tests/mini_semkitti_mseg3d.py (with
  ``frozen_stages=3``; random Flax variables), carried across by
  ``convert.save_flax_checkpoint``, run through ``python -m
  lidarseg3d_torch.tools.test CONFIG --checkpoint WORK_DIR --device cpu``
  (in-process) on a seeded SemanticKITTI tree (three frames, 1,200-1,500
  points each), against the JAX package's ``run_eval`` and
  ``evaluation`` on the same tree and weights: labels agree on at least
  99.9% of the points, and the two mIoUs are within 0.1 point. The JAX
  evaluation runs on a one-device mesh and its HRNet with ``s2d_max_c=0``
  (the space-to-depth layout is an exact rewrite of the same convolutions,
  and slow to trace at the mini config's widths).
- ``run_eval_device_hist``'s histogram equals the host histogram
  (``fast_hist``) of the same predictions exactly."""

import copy
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lidarseg3d_tpu.apis import eval as jeval
from lidarseg3d_tpu.apis import train as jtrain
from lidarseg3d_tpu.datasets import SegDataLoader as JLoader
from lidarseg3d_tpu.datasets import build_dataset as jbuild_dataset
from lidarseg3d_tpu.models import build_detector as jbuild
from lidarseg3d_tpu.parallel import mesh as jmesh
from lidarseg3d_torch.apis import eval as teval
from lidarseg3d_torch.apis import train as ttrain
from lidarseg3d_torch.convert import save_flax_checkpoint
from lidarseg3d_torch.core.seg_metrics import fast_hist
from lidarseg3d_torch.datasets import SegDataLoader, build_dataset
from lidarseg3d_torch.models import build_detector
from lidarseg3d_torch.solver.optim import build_one_cycle_optimizer
from lidarseg3d_torch.synthetic import (write_eval_config,
                                        write_semantickitti_tree)
from lidarseg3d_torch.tools import test as tool
from lidarseg3d_torch.utils.config import Config

from _torch_port_helpers import init_shapes, random_variables
from test_torch_port_support import (MINI_CONFIG, mini_config,
                                    one_torch_thread)
MIN_AGREE, MIOU_POINTS = 0.999, 0.1


def test_checkpoint_round_trip_and_partial_load(tmp_path):
    cfg = mini_config()

    def fresh():
        model = build_detector(copy.deepcopy(cfg.model.to_dict()),
                               device="cpu", seed=5)
        opt, _ = build_one_cycle_optimizer(dict(type="adam", wd=0.01),
                                           dict(lr_max=1e-3), 10)
        return ttrain.create_train_state(model, opt, seed=9)

    state = fresh()
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for t in list(state.model.state_dict().values()) \
                + state.opt_state.mu + state.opt_state.nu:
            t.copy_(torch.rand(t.shape, generator=gen))
    state.opt_state.count, state.step = 7, 7
    torch.rand(3, generator=state.generator)  # advance the generator
    path = ttrain.save_checkpoint(str(tmp_path), state, epoch=3)
    assert os.path.isfile(path)
    with open(tmp_path / "latest.txt") as f:
        assert f.read().strip() == "epoch_3"

    back, epoch = ttrain.load_checkpoint(str(tmp_path), fresh())
    assert epoch == 3 and back.step == 7 and back.opt_state.count == 7
    want_sd, got_sd = state.model.state_dict(), back.model.state_dict()
    assert set(want_sd) == set(got_sd)
    for k, v in want_sd.items():
        assert torch.equal(got_sd[k], v), k
    for a, b in zip(state.opt_state.mu + state.opt_state.nu,
                    back.opt_state.mu + back.opt_state.nu, strict=True):
        assert torch.equal(a, b)
    assert torch.equal(back.generator.get_state(), state.generator.get_state())

    part = fresh()
    part, epoch = ttrain.load_checkpoint(str(tmp_path), part, epoch=3,
                                         partial=True)
    assert epoch == 3 and part.step == 7 and part.opt_state.count == 0
    for k, v in want_sd.items():
        assert torch.equal(part.model.state_dict()[k], v), k
    assert all(not m.any() for m in part.opt_state.mu + part.opt_state.nu)


@pytest.fixture(scope="module")
def evaluated(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("eval")
    data_root, work_dir = str(tmp / "sequences"), str(tmp / "work")
    write_semantickitti_tree(data_root, sequences=("00",), frames=3,
                             points=(1200, 1500), seed=11,
                             image_hw=(64, 128), max_range=6.0)
    cfg_path = write_eval_config(str(tmp / "mini.py"), MINI_CONFIG,
                                 data_root, work_dir)
    cfg = Config.fromfile(cfg_path)
    ishape = tool.input_shape_of(cfg)
    cap = cfg.capacity

    # the JAX package's evaluation of a random train state
    jds = jbuild_dataset(copy.deepcopy(cfg.data.val.to_dict()))
    jloader = JLoader(jds, batch_size=1, shuffle=False, drop_last=False,
                      worker_mode="thread", num_workers=1, **cap)
    jcfg = copy.deepcopy(cfg.model.to_dict())
    jcfg["img_backbone"]["s2d_max_c"] = 0
    jm = jbuild(jcfg)
    b0 = next(jloader.epoch(0))
    jex = {k: jnp.asarray(b0[k]) for k in jtrain.DEVICE_BATCH_KEYS
           if k in b0}
    variables = random_variables(
        init_shapes(jm, dict(jex, input_shape=ishape), train=False), seed=2)
    jstate = jtrain.TrainState(step=jnp.zeros((), jnp.int32),
                               params=variables["params"],
                               batch_stats=variables["batch_stats"],
                               opt_state=())
    one_device = jmesh.make_mesh(jax.devices()[:1])
    real = jmesh.make_mesh
    jmesh.make_mesh = lambda: one_device
    try:
        jdets = jeval.run_eval(jm, jstate, jloader, ishape, jds)
    finally:
        jmesh.make_mesh = real
    jres, _ = jds.evaluation(jdets)

    # carried across, then the port's entry point on the CPU
    tm = build_detector(copy.deepcopy(cfg.model.to_dict()), device="cpu")
    save_flax_checkpoint(tm, jax.tree_util.tree_map(np.asarray,
                                                    variables["params"]),
                         jax.tree_util.tree_map(np.asarray,
                                                variables["batch_stats"]),
                         work_dir, epoch=1)
    out = tool.main([cfg_path, "--checkpoint", work_dir, "--device", "cpu",
                     "--speed_test"])
    return dict(cfg=cfg, jdets=jdets, jres=jres, out=out, tm=tm,
                ishape=ishape, work_dir=work_dir, data_root=data_root)


def test_entry_point_matches_jax_run_eval(evaluated):
    out, jdets = evaluated["out"], evaluated["jdets"]
    dets = out["detections"]
    assert set(dets) == set(jdets) and len(dets) == 3
    agree = total = 0
    for token, want in jdets.items():
        got = dets[token]["pred_point_sem_labels"]
        want = np.asarray(want["pred_point_sem_labels"])
        assert got.dtype == np.int32 and got.shape == want.shape
        agree += int((got == want).sum())
        total += got.size
    assert agree / total >= MIN_AGREE, agree / total
    got_miou = out["results"]["results"]["mIoU"]
    want_miou = evaluated["jres"]["results"]["mIoU"]
    assert np.isfinite(got_miou) and 0.0 <= got_miou <= 100.0
    assert abs(got_miou - want_miou) <= MIOU_POINTS, (got_miou, want_miou)
    assert len(out["latencies"]) == 3


def test_device_hist_equals_host_hist(evaluated):
    cfg, tm = evaluated["cfg"], evaluated["tm"]
    ds = build_dataset(copy.deepcopy(cfg.data.val.to_dict()))
    state = ttrain.TrainState(step=0, model=tm, opt_state=None,
                              generator=None)
    ttrain.load_checkpoint(evaluated["work_dir"], state, partial=True)
    with SegDataLoader(ds, 3, shuffle=False, drop_last=False,
                       num_workers=1, **cfg.capacity) as loader:
        miou, ious, hist = teval.run_eval_device_hist(
            tm, state, loader, evaluated["ishape"], ds, 20)
    want = 0
    for token, pred in evaluated["out"]["detections"].items():
        gt = ds.get_anno_for_eval(token)["point_sem_labels"]
        want = want + fast_hist(pred["pred_point_sem_labels"], gt, 20)
    assert hist.sum() > 0 and np.array_equal(hist, want)
    assert np.isfinite(miou) or np.isnan(ious).all()


def test_entry_point_refuses_a_missing_card_and_tta(evaluated, tmp_path):
    """Without a card the default device raises; a config whose test_cfg
    asks for TTA variants (tta_flag) raises without --tta, whose pipeline
    makes none (as the JAX package's run_eval asserts)."""
    cfg_path = write_eval_config(str(tmp_path / "c.py"), MINI_CONFIG,
                                 evaluated["data_root"], str(tmp_path))
    with open(cfg_path, "a") as f:
        f.write("test_cfg = dict(tta_flag=True, num_tta_tranforms=4)\n")
    args = [cfg_path, "--checkpoint", evaluated["work_dir"]]
    with pytest.raises(AssertionError, match="incomplete TTA groups"):
        tool.main(args + ["--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tool.main(args)
