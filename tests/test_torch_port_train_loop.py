"""The port's training entry point on the CPU: the train-mode loader,
``apis.train.train_segmentor`` with its hooks, checkpoints and resume, and
``python -m lidarseg3d_torch.tools.train``, on
configs/tests/mini_semkitti_mseg3d.py (with ``frozen_stages=3``, as
``synthetic.write_eval_config`` writes it) over a seeded tree of four
frames.

- The train-mode loader's batches (B=2, shuffled, seed 3) equal the JAX
  ``SegDataLoader``'s (thread mode) over two epochs, key by key, exactly.
- The JAX ``train_segmentor`` and the port's, one epoch of two steps from
  the same first weights (the JAX state that the JAX ``init_hook``
  receives, carried across by ``convert.load_flax_variables``; random
  variables of the init's shapes with non-trivial BN statistics, because
  the JAX package's eager init takes about 90 s on the CPU) with the
  point head's dropout at 0 on both sides (the frameworks draw different
  masks): every loss term and the gradient norm of both steps within 1e-4
  relative (the tolerance of test_torch_port_train_step.py), and the hook
  events in the same order. The JAX side runs on a one-device mesh, its
  HRNet with ``s2d_max_c=0`` and its step compiled at XLA's lowest
  optimisation level (test_torch_port_hrnet_frozen.py's settings).
- ``StopTraining`` from ``after_iter`` ends the epoch at once (its
  checkpoint is still written), from ``after_epoch`` ends training, from
  ``before_epoch`` ends it before that epoch runs (the JAX package's
  tests/test_train_integration.py:284-364, mirrored).
- A checkpoint every epoch and ``latest.txt``; two epochs straight give
  bit-identical parameters, BN statistics, Adam state and dropout
  generator to one epoch, a resume from ``latest.txt`` and one more epoch
  (dropout on); the resumed run starts at global step 2, and the learning
  rate there equals the JAX ``lr_fn``'s (float32) within 1e-6 relative.
- The tool from the command line with ``--device cpu --validate`` writes
  its checkpoints and prints an mIoU; an incomplete set of ``--dist_*``
  flags raises, a process group that does not start ends the run, and a
  frame that its shm workers cannot read raises."""

import copy
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidarseg3d_tpu.apis import train as jtrain
from lidarseg3d_tpu.datasets import SegDataLoader as JLoader
from lidarseg3d_tpu.datasets import build_dataset as jbuild_dataset
from lidarseg3d_tpu.models import build_detector as jbuild
from lidarseg3d_tpu.parallel import mesh as jmesh
from lidarseg3d_tpu.solver.optim import build_one_cycle_optimizer as jbuild_opt
from lidarseg3d_torch.apis import train as ttrain
from lidarseg3d_torch.convert import load_flax_variables
from lidarseg3d_torch.datasets import SegDataLoader, build_dataset
from lidarseg3d_torch.models import build_detector
from lidarseg3d_torch.synthetic import (write_eval_config,
                                        write_semantickitti_tree)
from lidarseg3d_torch.tools import test as eval_tool
from lidarseg3d_torch.tools import train as tool
from lidarseg3d_torch.utils.config import Config

from _torch_port_helpers import init_shapes, random_variables
from test_torch_port_support import MINI_CONFIG, one_torch_thread

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL_LOSS = 1e-4
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


class Recorder(ttrain.TrainerHook):
    """Records every event; raises StopTraining at the named ones."""

    def __init__(self, stop=(), losses=None):
        self.events, self.stop, self.losses = [], set(stop), losses

    def _note(self, *event):
        self.events.append(event)
        if event in self.stop:
            raise ttrain.StopTraining

    def before_run(self, state, loop):
        self.lr_fn = loop["lr_fn"]
        self._note("before_run", loop["total_epochs"])

    def before_epoch(self, state, epoch):
        self.start = (int(state.step), int(state.opt_state.count))
        self._note("before_epoch", epoch)

    def after_iter(self, state, ldict, global_step):
        if self.losses is not None:
            self.losses.append({k: float(v) for k, v in ldict.items()})
        self._note("after_iter", global_step)

    def after_epoch(self, state, epoch):
        self._note("after_epoch", epoch)

    def after_run(self, state):
        self._note("after_run")


class JaxRecorder(jtrain.TrainerHook):
    def __init__(self):
        self.events, self.losses = [], []

    def before_run(self, state, loop):
        self.events.append(("before_run", loop["total_epochs"]))

    def before_epoch(self, state, epoch):
        self.events.append(("before_epoch", epoch))

    def after_iter(self, state, ldict, global_step):
        self.losses.append({k: float(v) for k, v in ldict.items()})
        self.events.append(("after_iter", global_step))

    def after_epoch(self, state, epoch):
        self.events.append(("after_epoch", epoch))

    def after_run(self, state):
        self.events.append(("after_run",))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train")
    root = str(tmp / "sequences")
    write_semantickitti_tree(root, sequences=("00",), frames=4,
                             points=(1200, 1500), seed=8,
                             image_hw=(64, 128), max_range=6.0)
    cfg_path = write_eval_config(str(tmp / "mini.py"), MINI_CONFIG, root)
    nodrop = str(tmp / "nodrop.py")
    with open(cfg_path) as f, open(nodrop, "w") as g:
        g.write(f.read() + "model['point_head']['model_cfg']"
                "['DP_RATIO'] = 0\n")
    return dict(tmp=tmp, cfg_path=cfg_path, nodrop=nodrop,
                cfg=Config.fromfile(cfg_path))


def _loader(ds, cfg, cls=SegDataLoader, **kw):
    return cls(ds, batch_size=cfg.data.samples_per_gpu, shuffle=True,
               seed=0, num_workers=1, on_overflow="error", **cfg.capacity,
               **kw)


def _run(cfg, work, epochs, hooks=(), resume_from=None, init_hook=None,
         seed=0):
    """The port's train_segmentor on the mini config, on the CPU."""
    import logging

    model = build_detector(copy.deepcopy(cfg.model.to_dict()), device="cpu",
                           seed=seed)
    with _loader(build_dataset(cfg.data.train.to_dict()), cfg) as loader:
        return ttrain.train_segmentor(
            model=model, loader=loader,
            input_shape=eval_tool.input_shape_of(cfg),
            optimizer_cfg=dict(cfg.optimizer), lr_cfg=dict(cfg.lr_config),
            total_epochs=epochs, work_dir=str(work),
            logger=logging.getLogger("port_train_loop"), log_interval=1,
            resume_from=resume_from, seed=seed, init_hook=init_hook,
            hooks=hooks)


def test_train_batches_equal_jax_over_two_epochs(setup):
    cfg = setup["cfg"]
    ds = build_dataset(cfg.data.train.to_dict())
    jds = jbuild_dataset(cfg.data.train.to_dict())
    kw = dict(batch_size=2, shuffle=True, seed=3, num_workers=2,
              on_overflow="error", **cfg.capacity)
    jl = JLoader(jds, worker_mode="thread", **kw)
    with SegDataLoader(ds, **kw) as loader:
        for epoch in (0, 1):
            got, want = list(loader.epoch(epoch)), list(jl.epoch(epoch))
            assert len(got) == len(want) == 2
            for g, w in zip(got, want):
                assert set(g) == set(w), set(g) ^ set(w)
                assert "images_sem_labels" in g and "voxel_sem_labels" in g
                for k, v in w.items():
                    if k == "metadata":
                        assert g[k] == v
                    else:
                        assert g[k].dtype == v.dtype, k
                        assert np.array_equal(g[k], v), (epoch, k)


@pytest.fixture(scope="module")
def jax_and_port(setup):
    """One epoch (two steps) of the JAX and the port's train_segmentor
    from the same first weights."""
    import logging

    cfg = Config.fromfile(setup["nodrop"])
    ishape = eval_tool.input_shape_of(cfg)
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
        # the JAX package initialises eagerly on the CPU, op by op (about
        # 90 s for the mini model); random variables of the init's shapes
        # take a trace
        v = random_variables(init_shapes(model, example, train=False),
                             seed=1)
        return jtrain.TrainState(step=jnp.zeros((), jnp.int32),
                                 params=v["params"],
                                 batch_stats=v["batch_stats"],
                                 opt_state=tx.init(v["params"]))

    jrec = JaxRecorder()
    one_device = jmesh.make_mesh(jax.devices()[:1])
    real = jmesh.make_mesh, jax.jit, jtrain.create_train_state
    jmesh.make_mesh = lambda: one_device
    jax.jit = lambda *a, **kw: real[1](
        *a, **{"compiler_options": FAST_COMPILE, **kw})
    jtrain.create_train_state = abstract_init
    try:
        jl = _loader(jbuild_dataset(cfg.data.train.to_dict()), cfg,
                     cls=JLoader, worker_mode="thread")
        jtrain.train_segmentor(
            model=jm, loader=jl, input_shape=ishape,
            optimizer_cfg=dict(cfg.optimizer), lr_cfg=dict(cfg.lr_config),
            total_epochs=1, work_dir=str(setup["tmp"] / "jax_work"),
            logger=logging.getLogger("jax_train_loop"), log_interval=1,
            seed=0, init_hook=jhook, hooks=[jrec])
    finally:
        jmesh.make_mesh, jax.jit, jtrain.create_train_state = real

    def thook(state):
        load_flax_variables(state.model, first)
        return state

    losses = []
    trec = Recorder(losses=losses)
    _run(cfg, setup["tmp"] / "port_work", 1, hooks=[trec], init_hook=thook)
    return dict(jrec=jrec, trec=trec, losses=losses)


def test_first_two_steps_match_jax_train_segmentor(jax_and_port):
    want, got = jax_and_port["jrec"].losses, jax_and_port["losses"]
    assert len(want) == len(got) == 2
    for step, (w, g) in enumerate(zip(want, got)):
        assert set(g) == set(w), set(g) ^ set(w)
        for k, v in w.items():
            assert np.isfinite(g[k]), (step, k)
            assert abs(g[k] - v) <= REL_LOSS * max(abs(v), 1e-12), \
                (step, k, g[k], v)


def test_hook_events_follow_jax_order(jax_and_port):
    want = [("before_run", 1), ("before_epoch", 0), ("after_iter", 0),
            ("after_iter", 1), ("after_epoch", 1), ("after_run",)]
    assert jax_and_port["jrec"].events == want
    assert jax_and_port["trec"].events == want


def test_stop_training_from_after_epoch_ends_training(setup, tmp_path):
    rec = Recorder(stop=[("after_epoch", 1)])
    _run(setup["cfg"], tmp_path, 3, hooks=[rec])
    kinds = [e[0] for e in rec.events]
    assert kinds[:2] == ["before_run", "before_epoch"]
    assert kinds.count("after_epoch") == 1 and kinds[-1] == "after_run"
    assert sorted(os.listdir(tmp_path)) == ["epoch_1", "latest.txt"]


def test_stop_training_from_after_iter_ends_the_epoch_at_once(setup,
                                                              tmp_path):
    rec = Recorder(stop=[("after_iter", 0)])
    _run(setup["cfg"], tmp_path, 3, hooks=[rec])
    assert rec.events == [("before_run", 3), ("before_epoch", 0),
                          ("after_iter", 0), ("after_epoch", 1),
                          ("after_run",)]
    assert sorted(os.listdir(tmp_path)) == ["epoch_1", "latest.txt"]


def test_stop_training_from_before_epoch_skips_that_epoch(setup, tmp_path):
    rec = Recorder(stop=[("before_epoch", 1)])
    _run(setup["cfg"], tmp_path, 3, hooks=[rec])
    assert [e for e in rec.events if e[0] != "after_iter"] == [
        ("before_run", 3), ("before_epoch", 0), ("after_epoch", 1),
        ("before_epoch", 1), ("after_run",)]
    assert sorted(os.listdir(tmp_path)) == ["epoch_1", "latest.txt"]


def test_resume_is_bit_identical_to_training_straight(setup, tmp_path):
    cfg = setup["cfg"]
    straight = _run(cfg, tmp_path / "a", 2)
    assert sorted(os.listdir(tmp_path / "a")) == ["epoch_1", "epoch_2",
                                                  "latest.txt"]
    with open(tmp_path / "a" / "latest.txt") as f:
        assert f.read().strip() == "epoch_2"
    _run(cfg, tmp_path / "b", 2, hooks=[Recorder(stop=[("after_epoch", 1)])])
    rec = Recorder()
    # another seed for the fresh model: the resume must overwrite it all
    resumed = _run(cfg, tmp_path / "b", 2, hooks=[rec], resume_from=-1,
                   seed=5)
    assert rec.events[1] == ("before_epoch", 1)
    assert rec.start == (2, 2)  # global step and Adam count after epoch 1
    _, jlr = jbuild_opt(dict(cfg.optimizer), dict(cfg.lr_config), 4)
    want = float(jlr(rec.start[1]))
    assert abs(rec.lr_fn(rec.start[1]) - want) <= 1e-6 * want

    assert straight.step == resumed.step == 4
    sd_a, sd_b = straight.model.state_dict(), resumed.model.state_dict()
    assert set(sd_a) == set(sd_b)
    for k, v in sd_a.items():
        assert torch.equal(sd_b[k], v), k
    oa, ob = straight.opt_state, resumed.opt_state
    assert oa.count == ob.count == 4
    for x, y in zip(oa.mu + oa.nu, ob.mu + ob.nu, strict=True):
        assert torch.equal(x, y)
    assert torch.equal(straight.generator.get_state(),
                       resumed.generator.get_state())


def test_cli_trains_checkpoints_and_validates(setup, tmp_path):
    work = tmp_path / "work"
    out = subprocess.run(
        [sys.executable, "-m", "lidarseg3d_torch.tools.train",
         setup["cfg_path"], "--work_dir", str(work), "--device", "cpu",
         "--total_epochs", "2", "--max_steps_per_epoch", "1", "--validate"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    assert sorted(os.listdir(work)) == ["epoch_1", "epoch_2", "latest.txt",
                                        "train.log"]
    miou = [line for line in out.stdout.splitlines()
            if line.startswith("mIoU: ")]
    assert len(miou) == 2, out.stdout[-3000:]
    float(miou[0].split()[1])
    assert "Epoch [2/2][1/1]" in out.stdout
    assert "pretrained" not in out.stdout  # the mini config names none


@pytest.mark.parametrize("flag", [["--dist_coordinator", "localhost:1"],
                                  ["--dist_num_processes", "2"],
                                  ["--dist_process_id", "1"],
                                  ["--dist_coordinator", "localhost:1",
                                   "--dist_num_processes", "2",
                                   "--dist_process_id", "0"]])
def test_cli_refuses_unported_flags(setup, flag, monkeypatch):
    """The --dist_* flags: an incomplete set is refused; a complete one
    starts the process group it names, and a start that fails ends the
    run (no single-process fallback)."""
    import torch.distributed as tdist

    seen = []

    def no_coordinator(backend, init_method, world_size, rank):
        seen.append((backend, init_method, world_size, rank))
        raise RuntimeError("no coordinator at " + init_method)

    monkeypatch.setattr(tdist, "init_process_group", no_coordinator)
    complete = len(flag) == 6
    with pytest.raises(RuntimeError if complete else ValueError,
                       match="coordinator"):
        tool.main([setup["cfg_path"], "--device", "cpu"] + flag)
    assert seen == ([("gloo", "tcp://localhost:1", 2, 0)] if complete
                    else [])


def test_existing_pretrained_raises_and_missing_one_warns(setup, tmp_path,
                                                          capsys):
    weights = tmp_path / "hrnet.msgpack"
    weights.write_bytes(b"")
    base = open(setup["cfg_path"]).read()
    for path, name in ((weights, "have.py"), (tmp_path / "none", "miss.py")):
        (tmp_path / name).write_text(
            base + f"model['img_backbone']['pretrained'] = {str(path)!r}\n")
    # an existing file is imported (apis/pretrain.py); this empty one is
    # no msgpack, so reading it raises, as the JAX package's reader does
    with pytest.raises(ValueError, match="Unpack failed"):
        tool.main([str(tmp_path / "have.py"), "--device", "cpu",
                   "--work_dir", str(tmp_path / "w1")])
    tool.main([str(tmp_path / "miss.py"), "--device", "cpu", "--work_dir",
               str(tmp_path / "w2"), "--total_epochs", "1",
               "--max_steps_per_epoch", "1"])
    assert "pretrained HRNet not found" in capsys.readouterr().out
    assert os.path.isfile(tmp_path / "w2" / "epoch_1")


def test_shm_workers_and_a_missing_card_raise(setup, tmp_path):
    """Through the tool, the loader's shm workers surface the error of a
    frame they cannot read (frame 1: in the epoch's second batch, after
    the batch the loader builds itself for the slot layout)."""
    import shutil

    root = str(tmp_path / "sequences")
    shutil.copytree(setup["cfg"].data.train.root_path, root)
    order = np.random.default_rng(0).permutation(4)  # the sampler's epoch 0
    assert 1 in order[2:]
    os.remove(os.path.join(root, "00", "labels", "000001.label"))
    cfg = write_eval_config(str(tmp_path / "shm.py"), MINI_CONFIG, root)
    with open(cfg, "a") as f:
        f.write("data['worker_mode'] = 'shm'\n"
                "data['workers_per_gpu'] = 2\n")
    with pytest.raises(RuntimeError, match="loader worker failed"):
        tool.main([cfg, "--device", "cpu", "--work_dir",
                   str(tmp_path / "w")])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tool.main([setup["cfg_path"], "--work_dir", str(tmp_path / "w")])
