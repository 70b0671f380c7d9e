"""The port's SegDataLoader (thread mode) against the JAX package's, on a
seeded SemanticKITTI tree (three frames, mini config val pipeline) at batch
size 2 with the same seed, shuffle off and on, tail batch kept: the same
frame order, and every batch equal key by key, exactly, before and after
``pad_batch_rows`` (to a multiple of 4 rows). Also the samplers alone
(shuffle and drop_last on and off, three epochs), and the worker modes:
the ``process`` and ``shm`` batches of two epochs equal thread mode's bit
for bit, their workers see no card, the shared-memory blocks are gone
after ``shutdown``, and a worker's exception is raised in the main
process."""

import os

import numpy as np
import pytest

from lidarseg3d_tpu.datasets import SegDataLoader as JLoader
from lidarseg3d_tpu.datasets import build_dataset as jbuild_dataset
from lidarseg3d_tpu.datasets.batching import pad_batch_rows as jpad
from lidarseg3d_tpu.datasets.loader import EpochSampler as JSampler
from lidarseg3d_torch.datasets import (EpochSampler, SegDataLoader,
                                       build_dataset, pad_batch_rows)
from lidarseg3d_torch.synthetic import write_semantickitti_tree

from test_torch_port_support import mini_val_dataset_cfg, one_torch_thread

CAP = dict(max_voxels=1536, max_points=1536)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("semkitti"))
    write_semantickitti_tree(root, sequences=("00",), frames=3,
                             points=(1000, 1400), seed=4,
                             image_hw=(64, 128), max_range=6.0)
    return root


def _equal(got, want):
    assert set(got) == set(want), set(got) ^ set(want)
    for k, w in want.items():
        if k == "metadata":
            assert got[k] == w
        else:
            assert got[k].dtype == w.dtype and np.array_equal(got[k], w), k


@pytest.mark.parametrize("shuffle", [False, True])
def test_batches_equal_jax(tree, shuffle):
    ds = build_dataset(mini_val_dataset_cfg(tree))
    jds = jbuild_dataset(mini_val_dataset_cfg(tree))
    kw = dict(batch_size=2, shuffle=shuffle, seed=7, num_workers=2,
              drop_last=False, **CAP)
    with SegDataLoader(ds, **kw) as loader:
        got = list(loader.epoch(1))
    jl = JLoader(jds, worker_mode="thread", **kw)
    want = list(jl.epoch(1))
    assert np.array_equal(loader.sampler.epoch_indices(1),
                          jl.sampler.epoch_indices(1))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _equal(g, w)
        _equal(pad_batch_rows(g, 4), jpad(w, 4))
        assert pad_batch_rows(g, 4)["voxels"].shape[0] == 4


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
def test_sampler_equals_jax(shuffle, drop_last):
    for n in (1, 7, 9):
        s = EpochSampler(n, 2, shuffle=shuffle, seed=3, drop_last=drop_last)
        j = JSampler(n, 2, shuffle=shuffle, seed=3, drop_last=drop_last)
        for epoch in range(3):
            assert np.array_equal(s.epoch_indices(epoch),
                                  j.epoch_indices(epoch))
        assert s.steps_per_epoch() == j.steps_per_epoch()


class EnvDataset:
    """The val dataset, each frame's metadata noting the process's
    CUDA_VISIBLE_DEVICES (picklable: a worker imports this module)."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def get_sensor_data(self, i, rng=None):
        fr = self.ds.get_sensor_data(i, rng=rng)
        fr["metadata"] = dict(fr["metadata"], cuda=os.environ.get(
            "CUDA_VISIBLE_DEVICES"))
        return fr


def _epochs(ds, mode, **kw):
    with SegDataLoader(ds, 1, shuffle=True, seed=5, num_workers=2,
                       worker_mode=mode, **CAP, **kw) as loader:
        return [list(loader.epoch(e)) for e in (0, 1)]


@pytest.mark.parametrize("mode", ["process", "shm"])
def test_worker_modes_equal_thread(tree, mode):
    ds = EnvDataset(build_dataset(mini_val_dataset_cfg(tree)))
    want = _epochs(ds, "thread")
    got = _epochs(ds, mode)
    assert [len(e) for e in got] == [len(e) for e in want] == [3, 3]
    for ge, we in zip(got, want):
        for g, w in zip(ge, we):
            assert [m["cuda"] for m in g["metadata"]] == [""]
            for m in w["metadata"]:
                m.pop("cuda")
            for m in g["metadata"]:
                m.pop("cuda")
            _equal(g, w)


def test_shm_blocks_unlinked_after_shutdown(tree):
    from multiprocessing import shared_memory

    ds = build_dataset(mini_val_dataset_cfg(tree))
    loader = SegDataLoader(ds, 1, shuffle=False, num_workers=2,
                           worker_mode="shm", **CAP)
    assert len(list(loader.epoch(0))) == 3
    names = [b.name for b in loader._shm["blocks"]]
    procs = loader._shm["procs"]
    assert len(names) == 6 and all(p.is_alive() for p in procs)
    loader.shutdown()
    assert loader._shm is None and not any(p.is_alive() for p in procs)
    for name in names:
        with pytest.raises(FileNotFoundError):
            shared_memory.SharedMemory(name=name)
    loader.shutdown()  # a second shutdown is a no-op


@pytest.mark.parametrize("mode", ["process", "shm"])
def test_worker_exception_raised_in_main_process(tree, mode):
    ds = build_dataset(mini_val_dataset_cfg(tree))
    ds.files[2] = ds.files[2] + ".missing"  # frame 2: not batch 0
    with SegDataLoader(ds, 1, shuffle=False, num_workers=2,
                       worker_mode=mode, **CAP) as loader:
        it = loader.epoch(0)
        next(it)
        next(it)
        with pytest.raises((FileNotFoundError, RuntimeError),
                           match="missing"):
            next(it)


def test_unknown_worker_mode_raises(tree):
    ds = build_dataset(mini_val_dataset_cfg(tree))
    with pytest.raises(ValueError, match="worker_mode"):
        SegDataLoader(ds, 1, worker_mode="fork", **CAP)
