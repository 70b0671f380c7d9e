"""The nuScenes slice end to end on the CPU: the published nuScenes MSeg3D
config cut to a mini model (tests/test_torch_port_support.py
``write_mini_nusc_config``: two cameras at 96x64, a 25.6 m grid, tiny
HRNet with frozen_stages=3 and with_cp, ACT_REMAT) on a seeded tree of
synthetic.write_semnusc_tree (a val scene of three key frames, 1,500-2,000
points within 12 m, 1600x900 JPEGs) and its infos.

- A JAX train state of the config (random Flax variables), carried across
  by ``convert.save_flax_checkpoint``, run through ``python -m
  lidarseg3d_torch.tools.test CONFIG --checkpoint WORK_DIR --device cpu``
  (in-process) against the JAX package's ``run_eval`` and ``evaluation``
  on the same tree and weights: every point's label equal, the mIoUs
  within 1e-6. The JAX evaluation runs on a one-device mesh and its HRNet
  with ``s2d_max_c=0``, as in test_torch_port_eval.py.
- ``--testset`` writes the official ``{lidar_sd_token}_lidarseg.bin``
  files of those labels.
- Reference fault 7 (ROADMAP §C): the JAX ``sample_points_cuv`` gathers a
  point outside every camera at camera index ~-100, out of bounds, and
  returns NaN there; the port clamps the index and returns 0. Rows inside
  a camera agree."""

import copy
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
from lidarseg3d_tpu.ops.grid_sample import sample_points_cuv as jsample
from lidarseg3d_tpu.parallel import mesh as jmesh
from lidarseg3d_torch.convert import save_flax_checkpoint
from lidarseg3d_torch.datasets.nuscenes.common import (
    create_nuscenes_seg_infos)
from lidarseg3d_torch.models import build_detector
from lidarseg3d_torch.ops.grid_sample import sample_points_cuv
from lidarseg3d_torch.synthetic import write_semnusc_tree
from lidarseg3d_torch.tools import test as tool
from lidarseg3d_torch.utils.config import Config

from _torch_port_helpers import init_shapes, random_variables
from test_torch_port_support import (NUSC_CHANS, one_torch_thread,
                                     write_mini_nusc_config)

MIOU_TOL = 1e-6


@pytest.fixture(scope="module")
def evaluated(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("nusc_eval")
    root, work = str(tmp / "nusc"), str(tmp / "work")
    write_semnusc_tree(root, scenes=("scene-0003",), samples=3,
                       points=(1500, 2000), max_range=12.0, cams=NUSC_CHANS,
                       seed=12)
    create_nuscenes_seg_infos(root, cam_chans=NUSC_CHANS)
    cfg_path = write_mini_nusc_config(str(tmp / "mini.py"), root, work)
    cfg = Config.fromfile(cfg_path)
    ishape = tool.input_shape_of(cfg)

    jds = jbuild_dataset(copy.deepcopy(cfg.data.val.to_dict()))
    jloader = JLoader(jds, batch_size=1, shuffle=False, drop_last=False,
                      worker_mode="thread", num_workers=1, **cfg.capacity)
    jcfg = copy.deepcopy(cfg.model.to_dict())
    jcfg["img_backbone"]["s2d_max_c"] = 0
    jm = jbuild(jcfg)
    b0 = next(jloader.epoch(0))
    jex = {k: jnp.asarray(b0[k]) for k in jtrain.DEVICE_BATCH_KEYS
           if k in b0}
    variables = random_variables(
        init_shapes(jm, dict(jex, input_shape=ishape), train=False), seed=3)
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

    tm = build_detector(copy.deepcopy(cfg.model.to_dict()), device="cpu")
    save_flax_checkpoint(tm, jax.tree_util.tree_map(np.asarray,
                                                    variables["params"]),
                         jax.tree_util.tree_map(np.asarray,
                                                variables["batch_stats"]),
                         work, epoch=1)
    out = tool.main([cfg_path, "--checkpoint", work, "--device", "cpu"])
    return dict(cfg_path=cfg_path, work=work, jdets=jdets, jres=jres,
                out=out, root=root)


def test_entry_point_labels_equal_jax(evaluated):
    out, jdets = evaluated["out"], evaluated["jdets"]
    dets = out["detections"]
    assert set(dets) == set(jdets) and len(dets) == 3
    for token, want in jdets.items():
        got = dets[token]["pred_point_sem_labels"]
        want = np.asarray(want["pred_point_sem_labels"])
        assert got.dtype == np.int32 and got.shape == want.shape
        assert np.array_equal(got, want), token
    got_miou = out["results"]["results"]["mIoU"]
    want_miou = evaluated["jres"]["results"]["mIoU"]
    assert np.isfinite(got_miou) and 0.0 < got_miou <= 100.0
    assert abs(got_miou - want_miou) <= MIOU_TOL, (got_miou, want_miou)


def test_testset_writes_lidarseg_bins(evaluated, tmp_path):
    cfg_path = str(tmp_path / "test.py")
    with open(evaluated["cfg_path"]) as f, open(cfg_path, "w") as g:
        # the val infos stand in for the test split's
        g.write(f.read() + "data['test']['info_path'] = "
                "data['val']['info_path']\n")
    out = tool.main([cfg_path, "--checkpoint", evaluated["work"],
                     "--device", "cpu", "--testset", "--work_dir",
                     str(tmp_path)])
    assert out["results"] is None
    ds = jbuild_dataset(copy.deepcopy(
        Config.fromfile(cfg_path).data.test.to_dict()))
    sub = tmp_path / "results_folder" / "lidarseg" / "test"
    assert len(os.listdir(sub)) == 3
    for info in ds._infos:
        got = np.fromfile(sub / f"{info['lidar_sd_token']}_lidarseg.bin",
                          np.uint8)
        want = np.asarray(evaluated["jdets"][info["token"]][
            "pred_point_sem_labels"]).astype(np.uint8)
        assert np.array_equal(got, want)


def test_out_of_view_points_sample_zeros_not_nan():
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(1, 6, 4, 5, 3)).astype(np.float32)
    cuv = np.zeros((1, 4, 4), np.float32)
    cuv[0, :2] = [[1, -0.2, 0.1, -0.5], [1, 1.0, -1.0, 1.0]]  # in view
    # outside every camera: cam_id -100 -> (-100 - 1) / 5 * 2 - 1
    cuv[0, 2:] = [[0, -41.4, -67.0, -21.0], [0, -41.4, 3.0, 3.0]]
    got = sample_points_cuv(torch.from_numpy(feats), torch.from_numpy(cuv))
    want = np.asarray(jsample(jnp.asarray(feats), jnp.asarray(cuv)))
    np.testing.assert_allclose(got[0, :2].numpy(), want[0, :2], rtol=1e-6,
                               atol=1e-6)
    assert np.isnan(want[0, 2:]).all()  # the reference's fault
    assert (got[0, 2:] == 0).all()
