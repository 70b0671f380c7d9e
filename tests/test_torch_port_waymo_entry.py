"""Both published SemanticWaymo configs (MSeg3D: HRNet-w18, the FCN head,
the five-camera fusion head; and its lidar-only SegNet baseline) through
the port's entry points on the CPU, each cut to a mini model by
``synthetic.write_mini_waymo_config`` (the published pipelines, dataset,
optimizer and schedule; a 25.6 m grid, 96x64 images, HRNet
frozen_stages=3) over a seeded tree of ``synthetic.write_semanticwaymo_tree``
(two training and two validation frames of ~2,000 points, five cameras
at a tenth of the published widths):

- ``python -m lidarseg3d_torch.tools.test`` from a JAX train state
  (random Flax variables, ``convert.save_flax_checkpoint``) against the
  JAX package's ``run_eval`` and ``evaluation`` on the same tree and
  weights: every point's label equal, the mIoUs within 1e-6 (the JAX
  side on a one-device mesh, its HRNet with ``s2d_max_c=0``); with
  ``--testset`` the tool raises as the JAX dataset does without
  waymo_open_dataset;
- one ``train_segmentor`` step at B=2 against the JAX package's from the
  same first weights (dropout 0): the batches equal exactly, every loss
  term and the gradient norm within 1e-4 relative (the train-step limit
  of test_torch_port_train_step.py). For MSeg3D the JAX camera sampling
  gets the port's clamp of the camera index (ROADMAP §C fault 7: a point
  outside every camera makes the JAX step NaN, and a third of Waymo's
  points are outside the five cameras), as in
  test_torch_port_nusc_train.py;
- ``python -m lidarseg3d_torch.tools.train`` for an epoch of one step,
  then ``--resume_from`` for a second: the resumed state equals the
  checkpoint exactly and starts at its global step."""

import copy
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("cv2")

from lidarseg3d_tpu.apis import eval as jeval
from lidarseg3d_tpu.apis import train as jtrain
from lidarseg3d_tpu.datasets import SegDataLoader as JLoader
from lidarseg3d_tpu.datasets import build_dataset as jbuild_dataset
from lidarseg3d_tpu.models import build_detector as jbuild
from lidarseg3d_tpu.models.point_heads import mseg3d_head as jhead
from lidarseg3d_tpu.parallel import mesh as jmesh
from lidarseg3d_torch.apis import train as ttrain
from lidarseg3d_torch.convert import (load_flax_variables,
                                      save_flax_checkpoint)
from lidarseg3d_torch.datasets import SegDataLoader, build_dataset
from lidarseg3d_torch.models import build_detector
from lidarseg3d_torch.synthetic import (MINI_WAYMO_CAMS,
                                        write_mini_waymo_config,
                                        write_semanticwaymo_tree)
from lidarseg3d_torch.tools import test as test_tool
from lidarseg3d_torch.tools import train as train_tool
from lidarseg3d_torch.utils.config import Config

from _torch_port_helpers import init_shapes, random_variables
from test_torch_port_nusc_train import Losses, _clamped_sample
from test_torch_port_support import one_torch_thread  # noqa: F401
from test_torch_port_waymo import CONFIGS

MIOU_TOL, REL_LOSS = 1e-6, 1e-4
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("waymo_entry"))
    write_semanticwaymo_tree(root, frames=2, seed=9, top_cols=24,
                             max_range=12.0, short_points=400,
                             cam_hw=MINI_WAYMO_CAMS)
    return root


def mini(tree, name, tmp, dropout=True):
    path = write_mini_waymo_config(str(tmp / f"{name}.py"), CONFIGS[name],
                                   tree, str(tmp / "work"))
    if not dropout and name == "mseg3d":
        with open(path, "a") as f:
            f.write("model['point_head']['model_cfg']['DP_RATIO'] = 0\n")
    return path


def jax_model_cfg(cfg):
    m = copy.deepcopy(cfg.model.to_dict())
    if m.get("img_backbone"):
        m["img_backbone"]["s2d_max_c"] = 0
    return m


class one_device_jax:
    """The JAX package on a one-device mesh, its jit at XLA's cheapest
    optimisation level, no checkpoint written (the comparisons read the
    losses) and, with ``clamp``, the port's camera clamp."""

    def __init__(self, clamp=False, init=None):
        self.clamp, self.init = clamp, init

    def __enter__(self):
        self.real = (jmesh.make_mesh, jax.jit, jtrain.create_train_state,
                     jhead.gs.sample_points_cuv, jtrain.save_checkpoint)
        one = jmesh.make_mesh(jax.devices()[:1])
        jmesh.make_mesh = lambda: one
        jtrain.save_checkpoint = lambda *a, **kw: None
        jax.jit = lambda *a, **kw: self.real[1](
            *a, **{"compiler_options": FAST_COMPILE, **kw})
        if self.init is not None:
            jtrain.create_train_state = self.init
        if self.clamp:
            jhead.gs.sample_points_cuv = _clamped_sample

    def __exit__(self, *exc):
        (jmesh.make_mesh, jax.jit, jtrain.create_train_state,
         jhead.gs.sample_points_cuv, jtrain.save_checkpoint) = self.real


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def evaluated(request, tree, tmp_path_factory):
    name = request.param
    tmp = tmp_path_factory.mktemp(f"waymo_eval_{name}")
    cfg_path = mini(tree, name, tmp)
    cfg = Config.fromfile(cfg_path)
    ishape = test_tool.input_shape_of(cfg)
    jds = jbuild_dataset(copy.deepcopy(cfg.data.val.to_dict()))
    jloader = JLoader(jds, batch_size=1, shuffle=False, drop_last=False,
                      worker_mode="thread", num_workers=1, **cfg.capacity)
    jm = jbuild(jax_model_cfg(cfg))
    b0 = next(jloader.epoch(0))
    jex = {k: jnp.asarray(b0[k]) for k in jtrain.DEVICE_BATCH_KEYS
           if k in b0}
    variables = random_variables(
        init_shapes(jm, dict(jex, input_shape=ishape), train=False), seed=3)
    jstate = jtrain.TrainState(step=jnp.zeros((), jnp.int32),
                               params=variables["params"],
                               batch_stats=variables["batch_stats"],
                               opt_state=())
    with one_device_jax():
        jdets = jeval.run_eval(jm, jstate, jloader, ishape, jds)
    jres, _ = jds.evaluation(jdets)
    work = str(tmp / "ckpt")
    save_flax_checkpoint(
        build_detector(copy.deepcopy(cfg.model.to_dict()), device="cpu"),
        jax.tree_util.tree_map(np.asarray, variables["params"]),
        jax.tree_util.tree_map(np.asarray, variables["batch_stats"]),
        work, epoch=1)
    out = test_tool.main([cfg_path, "--checkpoint", work, "--device", "cpu"])
    return dict(name=name, cfg_path=cfg_path, work=work, jdets=jdets,
                jres=jres, out=out, tmp=tmp)


def test_entry_point_labels_equal_jax(evaluated):
    dets, jdets = evaluated["out"]["detections"], evaluated["jdets"]
    assert set(dets) == set(jdets) and len(dets) == 2
    for token, want in jdets.items():
        got = dets[token]["pred_point_sem_labels"]
        want = np.asarray(want["pred_point_sem_labels"])
        assert got.shape == want.shape and np.array_equal(got, want), token
        assert got.max() < 23
    got = evaluated["out"]["results"]["results"]
    want = evaluated["jres"]["results"]
    assert set(got) == set(want)
    assert abs(got["mIoU"] - want["mIoU"]) <= MIOU_TOL, (got, want)
    assert np.isfinite(got["mIoU"])


def test_testset_needs_waymo_open_dataset(evaluated, tmp_path):
    cfg_path = str(tmp_path / "test.py")
    with open(evaluated["cfg_path"]) as f, open(cfg_path, "w") as g:
        g.write(f.read() + "data['test']['info_path'] = "
                "data['val']['info_path']\n")
    with pytest.raises(RuntimeError, match="waymo_open_dataset"):
        test_tool.main([cfg_path, "--checkpoint", evaluated["work"],
                        "--device", "cpu", "--testset", "--work_dir",
                        str(tmp_path)])


def _loader(ds, cfg, cls, **kw):
    return cls(ds, batch_size=2, shuffle=True, seed=0, num_workers=1,
               on_overflow="error", **cfg.capacity, **kw)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def steps(request, tree, tmp_path_factory):
    name = request.param
    tmp = tmp_path_factory.mktemp(f"waymo_train_{name}")
    cfg = Config.fromfile(mini(tree, name, tmp, dropout=False))
    ishape = test_tool.input_shape_of(cfg)
    first = {}

    def abstract_init(model, example, rng, tx):
        v = random_variables(init_shapes(model, example, train=False),
                             seed=1)
        first.update(jax.tree_util.tree_map(np.asarray, v))
        return jtrain.TrainState(step=jnp.zeros((), jnp.int32),
                                 params=v["params"],
                                 batch_stats=v["batch_stats"],
                                 opt_state=tx.init(v["params"]))

    jrec = Losses()
    with one_device_jax(clamp=name == "mseg3d", init=abstract_init):
        jl = _loader(jbuild_dataset(cfg.data.train.to_dict()), cfg, JLoader,
                     worker_mode="thread")
        jbatch = next(jl.epoch(0))
        jtrain.train_segmentor(
            model=jbuild(jax_model_cfg(cfg)), loader=jl, input_shape=ishape,
            optimizer_cfg=dict(cfg.optimizer), lr_cfg=dict(cfg.lr_config),
            total_epochs=1, work_dir=str(tmp / "jax"),
            logger=logging.getLogger("jax_waymo"), log_interval=1, seed=0,
            hooks=[jrec])

    def thook(state):
        load_flax_variables(state.model, first)
        return state

    rec = Losses()
    model = build_detector(copy.deepcopy(cfg.model.to_dict()), device="cpu")
    with _loader(build_dataset(cfg.data.train.to_dict()), cfg,
                 SegDataLoader) as loader:
        batch = next(loader.epoch(0))
        ttrain.train_segmentor(
            model=model, loader=loader, input_shape=ishape,
            optimizer_cfg=dict(cfg.optimizer), lr_cfg=dict(cfg.lr_config),
            total_epochs=1, work_dir=str(tmp / "port"),
            logger=logging.getLogger("port_waymo"), log_interval=1, seed=0,
            init_hook=thook, hooks=[rec])
    return dict(name=name, jlosses=jrec.losses, losses=rec.losses,
                batch=batch, jbatch=jbatch)


def test_train_batches_equal(steps):
    got, want = steps["batch"], steps["jbatch"]
    assert set(got) == set(want), set(got) ^ set(want)
    for k, v in want.items():
        assert got[k] == v if k == "metadata" else (
            got[k].dtype == v.dtype and np.array_equal(got[k], v)), k
    if steps["name"] == "mseg3d":
        assert got["images"].shape[:2] == (2, 5)
        assert (got["points_cuv"][..., 0] == 0).any()


def test_train_step_matches_jax(steps):
    want, got = steps["jlosses"], steps["losses"]
    assert len(want) == len(got) == 1
    assert set(got[0]) == set(want[0]), set(got[0]) ^ set(want[0])
    for k, v in want[0].items():
        assert np.isfinite(v), k
        assert abs(got[0][k] - v) <= REL_LOSS * max(abs(v), 1e-12), \
            (k, got[0][k], v)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_train_tool_trains_and_resumes(tree, name, tmp_path):
    path = mini(tree, name, tmp_path)
    work = str(tmp_path / "w")
    args = [path, "--work_dir", work, "--device", "cpu"]
    train_tool.main(args + ["--total_epochs", "1"])
    assert sorted(os.listdir(work)) == ["epoch_1", "latest.txt",
                                        "train.log"]

    class Check(ttrain.TrainerHook):
        def before_run(self, state, loop):
            ckpt = torch.load(os.path.join(work, "epoch_1"),
                              map_location="cpu", weights_only=True)
            self.diff = [k for k, v in state.model.state_dict().items()
                         if not torch.equal(v, ckpt["model"][k])]
            self.start = state.step

        def after_iter(self, state, ldict, global_step):
            self.first = getattr(self, "first", global_step)
            self.finite = all(np.isfinite(float(v)) for v in ldict.values())

    check = Check()
    out = train_tool.main(args + ["--resume_from", "--total_epochs", "2"],
                          hooks=[check])
    assert check.diff == [] and check.start == 1 and check.first == 1
    assert check.finite and out["state"].step == 2
