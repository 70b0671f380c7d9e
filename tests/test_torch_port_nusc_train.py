"""One ``train_segmentor`` step of the nuScenes slice on the CPU against the
JAX package's: the mini nuScenes MSeg3D config
(tests/test_torch_port_support.py ``write_mini_nusc_config``; two
cameras, frozen_stages=3, with_cp, ACT_REMAT, the published train
pipeline: point and image augmentations, the JPEG round trip, the label
splat) at B=2 over a seeded train scene of synthetic.write_semnusc_tree,
from the same first weights (random variables of the JAX init's shapes,
carried across by ``convert.load_flax_variables``), the point head's
dropout at 0 on both sides.

- Both loaders give the same batch, key by key, exactly.
- Reference fault 7 (ROADMAP §C): the JAX step is NaN on these batches,
  because its camera sampling returns NaN for the points outside every
  camera and the training-mode masked BN multiplies them into its
  statistics. The port's loss terms are finite.
- With the JAX ``sample_points_cuv`` given the port's clamp of the camera
  index (the only change; the module file is untouched), every loss term
  and the gradient norm of the JAX step agree with the port's within 1e-4
  relative (the tolerance of test_torch_port_train_step.py). The JAX side
  runs on a one-device mesh, its HRNet with ``s2d_max_c=0`` and its step
  compiled at XLA's lowest optimisation level, as in
  test_torch_port_train_loop.py."""

import copy
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("cv2")

from lidarseg3d_tpu.apis import train as jtrain
from lidarseg3d_tpu.datasets import SegDataLoader as JLoader
from lidarseg3d_tpu.datasets import build_dataset as jbuild_dataset
from lidarseg3d_tpu.models import build_detector as jbuild
from lidarseg3d_tpu.models.point_heads import mseg3d_head as jhead
from lidarseg3d_tpu.parallel import mesh as jmesh
from lidarseg3d_torch.apis import train as ttrain
from lidarseg3d_torch.convert import load_flax_variables
from lidarseg3d_torch.datasets import SegDataLoader, build_dataset
from lidarseg3d_torch.datasets.nuscenes.common import (
    create_nuscenes_seg_infos)
from lidarseg3d_torch.models import build_detector
from lidarseg3d_torch.synthetic import write_semnusc_tree
from lidarseg3d_torch.tools import test as eval_tool
from lidarseg3d_torch.utils.config import Config

from _torch_port_helpers import init_shapes, random_variables
from test_torch_port_support import (NUSC_CHANS, one_torch_thread,
                                     write_mini_nusc_config)

REL_LOSS = 1e-4
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


class Losses:
    """Hook of either package: each step's loss terms as floats."""

    def __init__(self):
        self.losses = []

    def before_run(self, state, loop):
        pass

    def before_epoch(self, state, epoch):
        pass

    def after_iter(self, state, ldict, global_step):
        self.losses.append({k: float(v) for k, v in ldict.items()})

    def after_epoch(self, state, epoch):
        pass

    def after_run(self, state):
        pass


_REAL_SAMPLE = jhead.gs.sample_points_cuv


def _clamped_sample(features, points_cuv):
    """The JAX sampling with the port's clamp of the camera index: the
    normalised camera column is rewritten so that it rounds to the
    clamped index."""
    ncam = features.shape[1]
    if ncam == 1:
        return _REAL_SAMPLE(features, points_cuv)
    cam = jnp.clip(jnp.round((points_cuv[..., 1] + 1.0) * 0.5 * (ncam - 1)),
                   0, ncam - 1)
    return _REAL_SAMPLE(features, points_cuv.at[..., 1].set(
        cam / (ncam - 1) * 2.0 - 1.0))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("nusc_train")
    root = str(tmp / "nusc")
    write_semnusc_tree(root, scenes=("scene-0001",), samples=2,
                       points=(1500, 2000), max_range=12.0, cams=NUSC_CHANS,
                       seed=13)
    create_nuscenes_seg_infos(root, cam_chans=NUSC_CHANS)
    cfg_path = write_mini_nusc_config(str(tmp / "mini.py"), root)
    with open(cfg_path, "a") as f:
        f.write("model['point_head']['model_cfg']['DP_RATIO'] = 0\n")
    return dict(tmp=tmp, cfg=Config.fromfile(cfg_path))


def _loader(ds, cfg, cls, **kw):
    return cls(ds, batch_size=2, shuffle=True, seed=0, num_workers=1,
               on_overflow="error", **cfg.capacity, **kw)


def _jax_step(cfg, tmp, ishape, clamp):
    jcfg = copy.deepcopy(cfg.model.to_dict())
    jcfg["img_backbone"]["s2d_max_c"] = 0
    jm = jbuild(jcfg)
    first = {}

    def jhook(state):
        first.update(params=jax.tree_util.tree_map(np.asarray, state.params),
                     batch_stats=jax.tree_util.tree_map(np.asarray,
                                                        state.batch_stats))
        return state

    def abstract_init(model, example, rng, tx):
        v = random_variables(init_shapes(model, example, train=False),
                             seed=1)
        return jtrain.TrainState(step=jnp.zeros((), jnp.int32),
                                 params=v["params"],
                                 batch_stats=v["batch_stats"],
                                 opt_state=tx.init(v["params"]))

    rec = Losses()
    one_device = jmesh.make_mesh(jax.devices()[:1])
    real = (jmesh.make_mesh, jax.jit, jtrain.create_train_state,
            jhead.gs.sample_points_cuv)
    jmesh.make_mesh = lambda: one_device
    jax.jit = lambda *a, **kw: real[1](
        *a, **{"compiler_options": FAST_COMPILE, **kw})
    jtrain.create_train_state = abstract_init
    if clamp:
        jhead.gs.sample_points_cuv = _clamped_sample
    try:
        jl = _loader(jbuild_dataset(cfg.data.train.to_dict()), cfg, JLoader,
                     worker_mode="thread")
        batch = next(jl.epoch(0))
        jtrain.train_segmentor(
            model=jm, loader=jl, input_shape=ishape,
            optimizer_cfg=dict(cfg.optimizer), lr_cfg=dict(cfg.lr_config),
            total_epochs=1, work_dir=str(tmp / f"jax_{clamp}"),
            logger=logging.getLogger("jax_nusc"), log_interval=1, seed=0,
            init_hook=jhook, hooks=[rec])
    finally:
        (jmesh.make_mesh, jax.jit, jtrain.create_train_state,
         jhead.gs.sample_points_cuv) = real
    return rec.losses, first, batch


@pytest.fixture(scope="module")
def steps(setup):
    cfg, tmp = setup["cfg"], setup["tmp"]
    ishape = eval_tool.input_shape_of(cfg)
    jnan, _, _ = _jax_step(cfg, tmp, ishape, clamp=False)
    jlosses, first, jbatch = _jax_step(cfg, tmp, ishape, clamp=True)

    def thook(state):
        load_flax_variables(state.model, first)
        return state

    model = build_detector(copy.deepcopy(cfg.model.to_dict()), device="cpu")
    rec = Losses()
    with _loader(build_dataset(cfg.data.train.to_dict()), cfg,
                 SegDataLoader) as loader:
        batch = next(loader.epoch(0))
        ttrain.train_segmentor(
            model=model, loader=loader, input_shape=ishape,
            optimizer_cfg=dict(cfg.optimizer), lr_cfg=dict(cfg.lr_config),
            total_epochs=1, work_dir=str(tmp / "port"),
            logger=logging.getLogger("port_nusc"), log_interval=1, seed=0,
            init_hook=thook, hooks=[rec])
    return dict(jnan=jnan, jlosses=jlosses, losses=rec.losses, batch=batch,
                jbatch=jbatch)


def test_batches_equal(steps):
    got, want = steps["batch"], steps["jbatch"]
    assert set(got) == set(want), set(got) ^ set(want)
    assert "images_sem_labels" in got and got["images"].shape[:2] == (2, 2)
    for k, v in want.items():
        if k == "metadata":
            assert got[k] == v
        else:
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
    # points outside both cameras: the rows that reach the fault
    assert (got["points_cuv"][..., 0] == 0).any()


def test_reference_step_is_nan_port_is_finite(steps):
    assert len(steps["jnan"]) == len(steps["losses"]) == 1
    assert not np.isfinite(steps["jnan"][0]["loss"])
    assert all(np.isfinite(v) for v in steps["losses"][0].values())


def test_step_matches_jax_with_the_clamp(steps):
    want, got = steps["jlosses"], steps["losses"]
    assert len(want) == len(got) == 1
    assert set(got[0]) == set(want[0]), set(got[0]) ^ set(want[0])
    for k, v in want[0].items():
        assert np.isfinite(v), k
        assert abs(got[0][k] - v) <= REL_LOSS * max(abs(v), 1e-12), \
            (k, got[0][k], v)
