"""The panoptic instance tooling against the JAX package's, on a seeded
SemanticKITTI tree (synthetic.write_semantickitti_tree: walls of thing
classes carry instance ids):

- the SemanticKITTI dataset's ``save_instance`` writes the same instance
  files, byte for byte, and the same library pkl (paths under each
  output directory) as JAX's, at two ``min_points``;
- ``SegInstanceAug`` (in the train pipeline after the annotations)
  pastes the same instances, turned and mirrored alike, from the same
  ``rng``: points and labels equal exactly, over several seeds, with a
  class subset and with rotation and flip off; a frame without labels
  (val) passes unchanged."""

import copy
import os
import pickle

import numpy as np
import pytest

from lidarseg3d_tpu.datasets import build_dataset as jbuild_dataset
from lidarseg3d_torch.datasets import build_dataset
from lidarseg3d_torch.synthetic import write_semantickitti_tree


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("inst") / "sequences")
    write_semantickitti_tree(root, ("00",), frames=3, points=(3000, 3500),
                             seed=7, with_images=False, max_range=10.0)
    return root


def kitti(root, pipeline=(), test_mode=False):
    return dict(type="SemanticKITTIDataset", root_path=root,
                sequences=["00"], pipeline=list(pipeline),
                test_mode=test_mode)


def listing(out):
    files = {}
    for d, _, names in os.walk(out):
        for n in names:
            p = os.path.join(d, n)
            files[os.path.relpath(p, out)] = p
    return files


@pytest.mark.parametrize("min_points", [5, 15])
def test_save_instance_writes_jax_files(tree, tmp_path, min_points):
    got_dir, want_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    got_pkl = build_dataset(kitti(tree)).save_instance(got_dir, min_points)
    want_pkl = jbuild_dataset(kitti(tree)).save_instance(want_dir,
                                                         min_points)
    got, want = listing(got_dir), listing(want_dir)
    assert set(got) == set(want) and len(want) > 3
    for k in want:
        if k != "instance_path.pkl":
            with open(got[k], "rb") as a, open(want[k], "rb") as b:
                assert a.read() == b.read(), k
    with open(got_pkl, "rb") as f:
        glib = pickle.load(f)
    with open(want_pkl, "rb") as f:
        wlib = pickle.load(f)
    assert glib == {c: [p.replace(want_dir, got_dir) for p in v]
                    for c, v in wlib.items()}
    assert sum(len(v) for v in glib.values()) == len(want) - 1


@pytest.fixture(scope="module")
def library(tree, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("lib"))
    return jbuild_dataset(kitti(tree)).save_instance(out, 10)


AUGS = {"default": {}, "subset": dict(classes=[1, 2, 5], max_instances=4),
        "plain": dict(random_rotate=False, random_flip=False,
                      max_instances=3)}


@pytest.mark.parametrize("aug", sorted(AUGS))
def test_instance_paste_equals_jax(tree, library, aug):
    pipe = [dict(type="LoadPointCloudFromFile"),
            dict(type="LoadPointCloudAnnotations"),
            dict(type="SegInstanceAug",
                 cfg=dict(instance_pkl=library, **AUGS[aug]))]
    ds, jds = build_dataset(kitti(tree, pipe)), jbuild_dataset(
        kitti(tree, copy.deepcopy(pipe)))
    grew = 0
    for seed in range(4):
        got = ds.get_sensor_data(1, rng=np.random.default_rng(seed))
        want = jds.get_sensor_data(1, rng=np.random.default_rng(seed))
        assert np.array_equal(got["points"], want["points"])
        for k in ("point_sem_labels", "point_inst_labels"):
            g, w = got["annotations"][k], want["annotations"][k]
            assert g.dtype == w.dtype and np.array_equal(g, w), k
        n0 = len(np.fromfile(ds.load_infos(1)["path"], np.float32)) // 4
        grew += len(got["points"]) > n0
        if aug == "subset":
            assert set(got["annotations"]["point_sem_labels"][n0:]) <= {
                1, 2, 5}
    assert grew >= 2


def test_val_frame_passes_unchanged(tree, library):
    pipe = [dict(type="LoadPointCloudFromFile"),
            dict(type="SegInstanceAug", cfg=dict(instance_pkl=library))]
    got = build_dataset(kitti(tree, pipe, test_mode=True)).get_sensor_data(
        0, rng=np.random.default_rng(0))
    raw = np.fromfile(build_dataset(kitti(tree)).load_infos(0)["path"],
                      np.float32).reshape(-1, 4)
    assert np.array_equal(got["points"], raw)
