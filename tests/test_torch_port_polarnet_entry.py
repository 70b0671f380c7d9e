"""The three published SegPolarNet configs (Cylinder3D, Cylinder3D _v2p
and PolarNet on nuScenes) through the port's entry points on the CPU, each
cut to a mini model by ``synthetic.write_mini_polar_config`` (their
pipelines without a host voxelization, the points-only collate, dataset,
optimizer and schedule stay the published ones), over a seeded camera-less
nuScenes tree (a val scene and a train scene of two key frames, 1,500-2,000
points within 12 m) and its infos:

- random Flax variables of the JAX model (its _v2p branch with reference
  fault 12 repaired, tests/_segpolar_parity.py), carried across by
  ``convert.save_flax_checkpoint``, through ``python -m
  lidarseg3d_torch.tools.test`` against the JAX package's ``run_eval`` and
  ``evaluation`` on the same tree and weights: every point's label equal,
  the mIoUs within 1e-6 (the JAX run_eval takes the port's
  pad_batch_rows: its own reads the batch size from "voxels", which a
  points-only batch lacks, reference fault 10 in ROADMAP C);
- one train step of each through ``python -m lidarseg3d_torch.tools.train``
  with finite loss terms;
- ``--tb_log_dir`` writes TensorBoard event files holding the logged
  scalars, ``--profile_dir`` a torch.profiler trace of the steps (the last
  five of a run shorter than fifteen steps), and a published MSeg3D
  config's ``pretrained`` file is imported (its report in the train log)."""

import copy
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lidarseg3d_tpu.apis import eval as jeval
from lidarseg3d_tpu.apis import train as jtrain
from lidarseg3d_tpu.datasets import SegDataLoader as JLoader
from lidarseg3d_tpu.datasets import build_dataset as jbuild_dataset
from lidarseg3d_tpu.parallel import mesh as jmesh
from lidarseg3d_torch.apis import train as tr
from lidarseg3d_torch.apis.pretrain import write_msgpack
from lidarseg3d_torch.convert import save_flax_checkpoint, state_dict_to_flax
from lidarseg3d_torch.datasets import pad_batch_rows
from lidarseg3d_torch.datasets.nuscenes.common import (
    create_nuscenes_seg_infos)
from lidarseg3d_torch.models import build_detector
from lidarseg3d_torch.synthetic import write_mini_polar_config, write_semnusc_tree
from lidarseg3d_torch.tools import test as test_tool
from lidarseg3d_torch.tools import train as train_tool
from lidarseg3d_torch.utils.config import Config

import _segpolar_parity as P
from _torch_port_helpers import init_shapes, random_variables
from test_torch_port_support import MINI_CONFIG, one_torch_thread  # noqa: F401

CFG_DIR = MINI_CONFIG.rsplit("/configs/", 1)[0] + "/configs/semanticnusc/"
POLAR_CONFIGS = {
    "cylinder3d": "Cylinder3D/semnusc_dymanicvfe_cylinder3d_lr1en2_e12.py",
    "cylinder3d_v2p": "Cylinder3D/"
                      "semnusc_dymanicvfe_cylinder3d_v2p_lr1en2_e12.py",
    "polarnet": "PolarNet/semnusc_dymanicvfe_polarnet_lr1en2_e12.py",
}
MIOU_TOL = 1e-6
LOSSES = {"cylinder3d": {"out_ce_loss", "out_lvsz_loss"},
          "polarnet": {"out_ce_loss", "out_lvsz_loss"},
          "cylinder3d_v2p": {"conv_ce_loss", "conv_lovasz_loss",
                             "out_ce_loss", "out_lovasz_loss"}}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("polar_entry") / "nusc")
    write_semnusc_tree(root, scenes=("scene-0001", "scene-0003"), samples=2,
                       points=(1500, 2000), max_range=12.0, cams=(),
                       seed=31)
    create_nuscenes_seg_infos(root, cam_chans=())
    return root


def jax_eval(cfg, seed):
    """The JAX package's run_eval and evaluation of random variables of
    the config's model -> (detections, results, variables)."""
    jds = jbuild_dataset(copy.deepcopy(cfg.data.val.to_dict()))
    jloader = JLoader(jds, batch_size=1, shuffle=False, drop_last=False,
                      worker_mode="thread", num_workers=1, max_voxels=1,
                      max_points=cfg.capacity.max_points)
    jm = P.jbuild(copy.deepcopy(cfg.model.to_dict()))
    b0 = next(jloader.epoch(0))
    jex = {k: jnp.asarray(b0[k]) for k in jtrain.DEVICE_BATCH_KEYS
           if k in b0}
    assert "voxels" not in b0 and "points" in b0
    variables = random_variables(init_shapes(jm, jex, train=False), seed)
    jstate = jtrain.TrainState(step=jnp.zeros((), jnp.int32),
                               params=variables["params"],
                               batch_stats=variables["batch_stats"],
                               opt_state=())
    one_device = jmesh.make_mesh(jax.devices()[:1])
    real, real_pad = jmesh.make_mesh, jeval.pad_batch_rows
    jmesh.make_mesh = lambda: one_device
    # reference fault 10: the JAX pad_batch_rows reads the batch size from
    # "voxels", which a points-only batch lacks; the port's reads "points"
    jeval.pad_batch_rows = pad_batch_rows
    try:
        jdets = jeval.run_eval(jm, jstate, jloader, None, jds)
    finally:
        jmesh.make_mesh, jeval.pad_batch_rows = real, real_pad
    return jdets, jds.evaluation(jdets)[0], variables


@pytest.mark.parametrize("name", sorted(POLAR_CONFIGS))
def test_published_config_evaluates_as_jax_and_trains(tree, name, tmp_path):
    path = write_mini_polar_config(str(tmp_path / f"{name}.py"),
                                   CFG_DIR + POLAR_CONFIGS[name], tree,
                                   str(tmp_path / "work"))
    cfg = Config.fromfile(path)
    assert cfg.model.type == "SegPolarNet" and test_tool.input_shape_of(
        cfg) is None
    jdets, jres, variables = jax_eval(cfg, seed=5)
    ckpt = str(tmp_path / "ckpt")
    save_flax_checkpoint(
        build_detector(cfg.model.to_dict(), device="cpu"),
        jax.tree_util.tree_map(np.asarray, variables["params"]),
        jax.tree_util.tree_map(np.asarray, variables["batch_stats"]), ckpt, 1)
    out = test_tool.main([path, "--checkpoint", ckpt, "--device", "cpu"])
    dets = out["detections"]
    assert set(dets) == set(jdets) and len(dets) == 2
    for token, want in jdets.items():
        got = dets[token]["pred_point_sem_labels"]
        want = np.asarray(want["pred_point_sem_labels"])
        assert got.shape == want.shape and np.array_equal(got, want), token
    miou = out["results"]["results"]["mIoU"]
    assert np.isfinite(miou) and abs(miou - jres["results"]["mIoU"]) \
        <= MIOU_TOL

    losses = []

    class Record(tr.TrainerHook):
        def after_iter(self, state, ldict, global_step):
            losses.append({k: float(v) for k, v in ldict.items()})

    res = train_tool.main([path, "--device", "cpu", "--total_epochs", "1",
                           "--max_steps_per_epoch", "1"], hooks=[Record()])
    assert len(losses) == 1 and res["state"].step == 1
    assert set(losses[0]) == LOSSES[name] | {"loss", "grad_norm"}
    assert all(np.isfinite(v) for v in losses[0].values())


def test_tensorboard_and_profiler_trace(tree, tmp_path):
    path = write_mini_polar_config(str(tmp_path / "p.py"),
                                   CFG_DIR + POLAR_CONFIGS["polarnet"], tree,
                                   str(tmp_path / "work"))
    tb, prof = str(tmp_path / "tb"), str(tmp_path / "prof")
    train_tool.main([path, "--device", "cpu", "--total_epochs", "2",
                     "--max_steps_per_epoch", "1", "--tb_log_dir", tb,
                     "--profile_dir", prof])
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator)

    acc = EventAccumulator(tb)
    acc.Reload()
    tags = set(acc.Tags()["scalars"])
    assert {"lr", "loss", "grad_norm", "out_ce_loss"} <= tags
    assert [e.step for e in acc.Scalars("loss")] == [1, 2]
    traces = glob.glob(os.path.join(prof, "trace_steps_*.json"))
    assert [os.path.basename(t) for t in traces] == ["trace_steps_0-1.json"]
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)


def test_train_tool_imports_the_pretrained_hrnet(tmp_path):
    """The mini MSeg3D config with its HRNet's ``pretrained`` pointing at a
    converted file: the tool grafts it in before the first step and the
    train log reports every tensor loaded, none skipped."""
    from lidarseg3d_torch.synthetic import (write_eval_config,
                                            write_semantickitti_tree)

    root = str(tmp_path / "sequences")
    write_semantickitti_tree(root, ("00",), frames=2, points=(1200, 1500),
                             seed=4, image_hw=(64, 128), max_range=6.0)
    path = write_eval_config(str(tmp_path / "mini.py"), MINI_CONFIG, root)
    cfg = Config.fromfile(path)
    hr = build_detector(cfg.model.to_dict(), device="cpu",
                        seed=9).img_backbone_mod
    blob = state_dict_to_flax(hr)
    ckpt = str(tmp_path / "hrnet.msgpack")
    write_msgpack(blob, ckpt)
    with open(path, "a") as f:
        f.write(f"model['img_backbone']['pretrained'] = {ckpt!r}\n")
    seen = {}

    class Grab(tr.TrainerHook):
        def before_run(self, state, loop):
            seen.update({k: v.clone() for k, v in
                         state.model.img_backbone_mod.state_dict().items()})

    out = train_tool.main([path, "--device", "cpu", "--total_epochs", "1",
                           "--max_steps_per_epoch", "1"], hooks=[Grab()])
    want = hr.state_dict()
    assert set(seen) == set(want)
    assert all(np.array_equal(seen[k].numpy(), want[k].numpy()) for k in want)
    with open(os.path.join(out["work_dir"], "train.log")) as f:
        log = f.read()
    n = sum(1 for _ in jax.tree_util.tree_leaves(blob))
    assert f"pretrain report: loaded {n}, skipped 0, unexpected 0" in log
