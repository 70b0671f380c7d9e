"""Test-time augmentation (TTA) of lidarseg3d_torch against the JAX
package's, on seeded SemanticKITTI trees (CPU):

- SegCompoundAug's variant clouds and SegVoxelization's variant voxels are
  bit-exact against the JAX stages drawing from the same generator, for
  the SemanticKITTI and the nuScenes TTA configs' ``tta_cfg`` (the latter
  names keys SegCompoundAug does not read: both packages ignore them);
- the val pipeline under ``tools.test.tta_dataset_cfg`` returns
  Reformat's list of variants, the camera keys copied into each, equal to
  the JAX pipeline's;
- the loader makes a batch of b frames b * T consecutive rows in the
  thread, process and shm modes, equal to the JAX loader's;
- ``run_eval``'s merged labels equal the JAX ``run_eval``'s on the mini
  SegNet config (same random weights, the same variant batches);
- ``tools.test --tta --device cpu`` evaluates the published SDSeg3D TTA
  config cut to a mini model, and the mini MSeg3D config, every point of
  every frame labelled; a ``_tta`` config run without ``--tta`` raises."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lidarseg3d_tpu.apis import eval as jeval
from lidarseg3d_tpu.apis import train as jtrain
from lidarseg3d_tpu.datasets import SegDataLoader as JLoader
from lidarseg3d_tpu.datasets import build_dataset as jbuild_dataset
from lidarseg3d_tpu.datasets.pipelines import seg_preprocess as jsp
from lidarseg3d_tpu.models import build_detector as jbuild
from lidarseg3d_tpu.parallel import mesh as jmesh
from lidarseg3d_torch.apis import eval as teval
from lidarseg3d_torch.apis.train import TrainState, save_checkpoint
from lidarseg3d_torch.convert import load_flax_variables
from lidarseg3d_torch.datasets import SegDataLoader, build_dataset
from lidarseg3d_torch.datasets.pipelines import seg_preprocess as tsp
from lidarseg3d_torch.models import build_detector
from lidarseg3d_torch.synthetic import (write_eval_config,
                                        write_mini_segnet_config,
                                        write_semantickitti_tree)
from lidarseg3d_torch.tools import test as tool
from lidarseg3d_torch.utils.config import Config

from _torch_port_helpers import init_shapes, random_variables
from test_torch_port_support import MINI_CONFIG, mini_val_dataset_cfg
from test_torch_port_support import one_torch_thread  # noqa: F401

CFG_DIR = MINI_CONFIG.rsplit("/configs/", 1)[0] + "/configs/"
KITTI_TTA = CFG_DIR + ("semantickitti/SDSeg3D/"
                       "semkitti_transVFE_unetscn3d_batchloss_e10_tta.py")
NUSC_TTA = CFG_DIR + ("semanticnusc/SDSeg3D/"
                      "semnusc_transvfe_unetscn3d_batchloss_e48_tta.py")
MINI_SEGNET = CFG_DIR + "tests/mini_semkitti_segnet.py"
CAP = dict(max_voxels=1536, max_points=1536)
T = 3  # variants a frame in the loader and run_eval tests


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("semkitti") / "sequences")
    write_semantickitti_tree(root, sequences=("00", "08"), frames=3,
                             points=(1000, 1400), seed=6,
                             image_hw=(64, 128), max_range=6.0)
    return root


def _equal(got, want, what=""):
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for k, w in want.items():
        if k == "metadata":
            assert got[k] == w, what
        else:
            w = np.asarray(w)
            assert got[k].dtype == w.dtype and np.array_equal(got[k], w), (
                what, k)


def _val_sample(seed):
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.uniform(-20, 20, (3000, 3)),
                          rng.uniform(0, 1, (3000, 1))], 1).astype(np.float32)
    return {"mode": "val", "points": pts,
            "rng": np.random.default_rng(seed + 100)}


@pytest.mark.parametrize("config", [KITTI_TTA, NUSC_TTA])
def test_compound_aug_and_voxelization_bit_exact(config):
    cfg = Config.fromfile(config)
    tta = cfg.tta_cfg.to_dict()
    vox = dict(cfg.voxel_generator.to_dict(), tta_flag=True, **tta)
    ntta = tta["num_tta_tranforms"]
    info = {"dim": {"points": 4}}
    got, _ = tsp.SegVoxelization(cfg=vox)(
        *tsp.SegCompoundAug(cfg=tta)(_val_sample(1), info))
    want, _ = jsp.SegVoxelization(cfg=vox)(
        *jsp.SegCompoundAug(cfg=tta)(_val_sample(1), info))
    assert got["num_tta_transforms"] == want["num_tta_transforms"] == ntta
    for i in range(1, ntta):
        p = got[f"tta_{i}_points"]
        assert p.dtype == np.float32 and np.array_equal(
            p, want[f"tta_{i}_points"])
        assert not np.array_equal(p, got["points"])
        for k in ("voxels", "coordinates", "num_points", "num_voxels"):
            assert np.array_equal(got[f"tta_{i}_voxels"][k],
                                  want[f"tta_{i}_voxels"][k]), (i, k)
    # both generators have drawn the same numbers in the same order
    assert got["rng"].random() == want["rng"].random()


def _tta_val_cfg(tree, ntta, config=None):
    """The mini MSeg3D val dataset over ``tree`` (cameras included) or a
    config's val dataset, with the --tta pipeline of T variants."""
    ds = (mini_val_dataset_cfg(tree) if config is None
          else copy.deepcopy(Config.fromfile(config).data.val.to_dict()))
    ds["root_path"] = tree
    ds["sequences"] = ["08"]
    return tool.tta_dataset_cfg(ds, dict(num_tta_tranforms=ntta))


def test_reformat_returns_the_variants_with_the_cameras(tree):
    cfg = _tta_val_cfg(tree, 4)
    assert [st["type"] for st in cfg["pipeline"]][-3:] == [
        "SegCompoundAug", "SegVoxelization", "Reformat"]
    got = build_dataset(copy.deepcopy(cfg)).get_sensor_data(
        1, rng=np.random.default_rng(3))
    want = jbuild_dataset(copy.deepcopy(cfg)).get_sensor_data(
        1, rng=np.random.default_rng(3))
    assert isinstance(got, list) and len(got) == len(want) == 4
    for i, (g, w) in enumerate(zip(got, want)):
        _equal(g, w, f"variant {i}")
        assert {"images", "points_cuv"} <= set(g)
        assert g["metadata"] == got[0]["metadata"]
        assert np.array_equal(g["images"], got[0]["images"])
        assert np.array_equal(g["points_cuv"], got[0]["points_cuv"])


def _batches(ds, mode, **kw):
    with SegDataLoader(ds, 2, shuffle=False, drop_last=False, num_workers=2,
                       worker_mode=mode, **CAP, **kw) as loader:
        return list(loader.epoch(0))


@pytest.mark.parametrize("mode", ["thread", "process", "shm"])
def test_loader_makes_t_rows_a_frame(tree, mode):
    cfg = _tta_val_cfg(tree, T)
    got = _batches(build_dataset(copy.deepcopy(cfg)), mode)
    jl = JLoader(jbuild_dataset(copy.deepcopy(cfg)), batch_size=2,
                 shuffle=False, drop_last=False, num_workers=2,
                 worker_mode="thread", **CAP)
    want = list(jl.epoch(0))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g["voxels"].shape[0] == 2 * T and len(g["metadata"]) == 2 * T
        tokens = [m["token"] for m in g["metadata"]]
        assert tokens[:T] == [tokens[0]] * T and tokens[T:] == [
            tokens[T]] * T and tokens[0] != tokens[T]
        _equal(g, w, mode)


@pytest.fixture(scope="module")
def segnet(tree):
    """The mini SegNet config over ``tree`` with random Flax variables on
    both sides, and the val dataset under --tta (T variants)."""
    cfg = Config.fromfile(MINI_SEGNET)
    ds_cfg = _tta_val_cfg(tree, T, MINI_SEGNET)
    jds = jbuild_dataset(copy.deepcopy(ds_cfg))
    jloader = JLoader(jds, batch_size=1, shuffle=False, drop_last=False,
                      worker_mode="thread", num_workers=1, **CAP)
    ishape = tool.input_shape_of(cfg)
    jm = jbuild(cfg.model.to_dict())
    b0 = next(jloader.epoch(0))
    jex = {k: jnp.asarray(b0[k]) for k in jtrain.DEVICE_BATCH_KEYS
           if k in b0}
    variables = random_variables(
        init_shapes(jm, dict(jex, input_shape=ishape), train=False), seed=4)
    tm = build_detector(cfg.model.to_dict(), device="cpu")
    load_flax_variables(tm, jax.tree_util.tree_map(np.asarray, variables))
    return dict(cfg=cfg, ds_cfg=ds_cfg, jds=jds, jloader=jloader,
                ishape=ishape, jm=jm, variables=variables, tm=tm)


def test_run_eval_merge_equals_jax(segnet):
    s = segnet
    test_cfg = dict(tta_flag=True, num_tta_tranforms=T)
    jstate = jtrain.TrainState(step=jnp.zeros((), jnp.int32),
                               params=s["variables"]["params"],
                               batch_stats=s["variables"]["batch_stats"],
                               opt_state=())
    one_device = jmesh.make_mesh(jax.devices()[:1])
    real = jmesh.make_mesh
    jmesh.make_mesh = lambda: one_device
    try:
        want = jeval.run_eval(s["jm"], jstate, s["jloader"], s["ishape"],
                              s["jds"], test_cfg=test_cfg)
    finally:
        jmesh.make_mesh = real
    ds = build_dataset(copy.deepcopy(s["ds_cfg"]))
    state = TrainState(step=0, model=s["tm"], opt_state=None, generator=None)
    with SegDataLoader(ds, 1, shuffle=False, drop_last=False, num_workers=1,
                       **CAP) as loader:
        got = teval.run_eval(s["tm"], state, loader, s["ishape"], ds,
                             test_cfg=test_cfg)
    # the frames alone (variant 0 only), for the merge to differ from
    plain = copy.deepcopy(s["ds_cfg"])
    plain["pipeline"] = [st for st in plain["pipeline"]
                         if st["type"] != "SegCompoundAug"]
    plain["pipeline"][-2]["cfg"]["tta_flag"] = False
    ds0 = build_dataset(plain)
    with SegDataLoader(ds0, 1, shuffle=False, drop_last=False,
                       num_workers=1, **CAP) as loader:
        alone = teval.run_eval(s["tm"], state, loader, s["ishape"], ds0)
    assert set(got) == set(want) == set(alone) and len(got) == 3
    changed = 0
    for token, w in want.items():
        g = got[token]["pred_point_sem_labels"]
        w = np.asarray(w["pred_point_sem_labels"])
        n = len(ds.get_anno_for_eval(token)["point_sem_labels"])
        assert g.shape == w.shape == (n,)
        assert np.array_equal(g, w), token
        changed += int((g != alone[token]["pred_point_sem_labels"]).sum())
    assert changed > 0  # the variants moved some points' labels


def test_entry_point_tta_on_mini_segnet_and_mseg3d(tree, tmp_path):
    """--tta through tools.test on the published SDSeg3D TTA config cut to
    a mini model (T=4) and on the mini MSeg3D config (the tool's default
    T=4): every point of every val frame labelled in range; without
    --tta the _tta config raises."""
    kitti = write_mini_segnet_config(str(tmp_path / "sd.py"), KITTI_TTA,
                                     tree, str(tmp_path / "w_sd"))
    mseg = write_eval_config(str(tmp_path / "ms.py"), MINI_CONFIG, tree,
                             str(tmp_path / "w_ms"))
    with open(mseg, "a") as f:
        f.write("for _split in ('val', 'test'):\n"
                "    data[_split]['sequences'] = ['08']\n")
    for path, seed in ((kitti, 1), (mseg, 2)):
        cfg = Config.fromfile(path)
        work = str(tmp_path / f"ckpt{seed}")
        save_checkpoint(work, TrainState(0, build_detector(
            cfg.model.to_dict(), device="cpu", seed=seed), None, None), 1)
        out = tool.main([path, "--checkpoint", work, "--tta", "--device",
                         "cpu"])
        ds = build_dataset(cfg.data.val.to_dict())
        assert len(out["detections"]) == len(ds) == 3
        for token, pred in out["detections"].items():
            labels = pred["pred_point_sem_labels"]
            n = len(ds.get_anno_for_eval(token)["point_sem_labels"])
            assert labels.shape == (n,) and 0 <= labels.min() \
                and labels.max() < 20
        assert np.isfinite(out["results"]["results"]["mIoU"])
    with pytest.raises(AssertionError, match="incomplete TTA groups"):
        tool.main([kitti, "--checkpoint", str(tmp_path / "ckpt1"),
                   "--device", "cpu"])
