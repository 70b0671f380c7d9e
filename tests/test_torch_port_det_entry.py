"""Both entry points on mini cuts (synthetic.write_mini_det_config) of all
five single-stage published detection configs, on the CPU: the two
nuScenes VoxelNet configs (rotated and circle NMS; 10 sweeps) over a
seeded nuScenes tree with boxes and sweeps, the Waymo VoxelNet 3x (its
db_sampler on the tree's gt database from ``create_data
waymo_gt_database``), two-sweep velocity and PointPillars configs over a
seeded Waymo tree with boxes.

``tools.train`` trains one step and writes its checkpoint; ``tools.test``
then evaluates a checkpoint of JAX's seeded variables
(convert.save_flax_checkpoint; spread BN statistics, so no two BEV cells
score within fp32 noise of each other or of the threshold, as trained or
untrained weights leave many) and writes the prediction pkl, the metrics
and the nuScenes JSON; its boxes equal the JAX package's
``run_det_eval`` on the same batches with the same variables: labels and
valid flags exact, boxes, scores and velocities within 1e-4. The
two-sweep velocity config's velocity head has no target in Waymo's
7-dim boxes (both packages' converters), so its training raises
(ROADMAP §C).
The nuScenes configs read CenterPoint's 5 point columns (x, y, z,
intensity, time lag), which the port's DetPreprocess makes of the
loader's 6 at 10 sweeps (test_torch_port_det_ops.py holds them against
the scans); the JAX side evaluates the same voxels (its own pipeline
keeps all 6, where its reader's width assert stops; ROADMAP §C)."""

import os

import numpy as np
import pytest

from lidarseg3d_torch import synthetic
from lidarseg3d_torch.datasets.nuscenes.common import create_nuscenes_seg_infos
from lidarseg3d_torch.tools import create_data
from lidarseg3d_torch.tools import test as ttest
from lidarseg3d_torch.tools import train as ttrain

from test_torch_port_support import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {
    "nusc": "configs/nusc/voxelnet/nusc_centerpoint_voxelnet_01voxel.py",
    "nusc_circle": "configs/nusc/voxelnet/"
                   "nusc_centerpoint_voxelnet_01voxel_circle_nms.py",
    "waymo": "configs/waymo/voxelnet/waymo_centerpoint_voxelnet_3x.py",
    "waymo_velo": "configs/waymo/voxelnet/"
                  "waymo_centerpoint_voxelnet_two_sweeps_3x_with_velo.py",
    "waymo_pp": "configs/waymo/pp/waymo_centerpoint_pp_two_pfn_stride1_3x.py",
}


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    base = tmp_path_factory.mktemp("det_trees")
    nu = str(base / "nusc")
    synthetic.write_semnusc_tree(
        nu, scenes=("scene-0003", "scene-0001"), samples=2,
        points=(1500, 2000), max_range=12.0, cams=(), boxes=10, sweeps=9,
        sweep_points=600, seed=5)
    create_nuscenes_seg_infos(nu, nsweeps=10, cam_chans=())
    wy = str(base / "waymo")
    synthetic.write_semanticwaymo_tree(
        wy, splits=("train", "val"), frames=2, top_cols=24, max_range=12.0,
        short_points=400, cams=(), boxes=9, seed=6)
    create_data.main(["waymo_gt_database", "--root", wy])
    return {"nusc": nu, "waymo": wy}


class _Loader:
    """The port loader's val batches of a config, for the JAX package's
    run_det_eval."""

    def __init__(self, cfg):
        from lidarseg3d_torch.datasets import build_dataset

        self.ds = build_dataset(cfg.data["val"].to_dict())
        self.cap = cfg.capacity

    def epoch(self, e):
        from lidarseg3d_torch.datasets import SegDataLoader

        with SegDataLoader(self.ds, 1, self.cap["max_voxels"],
                           self.cap["max_points"], shuffle=False,
                           drop_last=False, num_workers=1) as ld:
            yield from ld.epoch(e)


def _jax_side(cfg_path):
    """The config's JAX model, seeded Flax variables with spread BN
    statistics and scales (_torch_port_helpers.random_variables), and its
    run_det_eval on the port loader's batches -> (variables,
    detections)."""
    import jax
    import jax.numpy as jnp

    from lidarseg3d_tpu.apis.det_eval import run_det_eval
    from lidarseg3d_tpu.apis.train import TrainState
    from lidarseg3d_tpu.models import build_detector as jbuild
    from lidarseg3d_torch.tools.test import input_shape_of
    from lidarseg3d_torch.utils.config import Config

    from _torch_port_helpers import init_shapes, random_variables

    cfg = Config.fromfile(cfg_path)
    jm = jbuild(cfg.model.to_dict(), train_cfg=cfg.get("train_cfg"),
                test_cfg=cfg.get("test_cfg"))
    loader = _Loader(cfg)
    b = next(loader.epoch(0))
    ishape = input_shape_of(cfg)
    ex = {k: jnp.asarray(b[k]) for k in ("voxels", "coordinates",
                                          "num_points", "num_voxels")}
    v = jax.tree_util.tree_map(np.asarray, random_variables(
        init_shapes(jm, dict(ex, input_shape=ishape), train=False), 3))
    state = TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                       batch_stats=v["batch_stats"], opt_state=())
    return v, run_det_eval(jm, state, loader, ishape,
                           test_cfg=dict(cfg.get("test_cfg", {})))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_both_tools_match_jax(name, trees, tmp_path):
    from lidarseg3d_torch.convert import save_flax_checkpoint
    from lidarseg3d_torch.models import build_detector
    from lidarseg3d_torch.tools.test import model_config
    from lidarseg3d_torch.utils.config import Config

    tree = trees["nusc" if name.startswith("nusc") else "waymo"]
    work = str(tmp_path / "work")
    cfg = synthetic.write_mini_det_config(
        str(tmp_path / f"{name}.py"), os.path.join(ROOT, CONFIGS[name]),
        tree, work)
    args = [cfg, "--device", "cpu", "--total_epochs", "1",
            "--max_steps_per_epoch", "1"]
    if name == "waymo_velo":
        with pytest.raises(ValueError, match="velocity"):
            ttrain.main(args)
    else:
        ttrain.main(args)
        assert sorted(os.listdir(work)) == ["epoch_1", "latest.txt",
                                            "train.log"]
    v, want = _jax_side(cfg)
    save_flax_checkpoint(build_detector(model_config(Config.fromfile(cfg)),
                                       device="cpu"), v["params"],
                         v["batch_stats"], work, 2)
    res = ttest.main([cfg, "--checkpoint", os.path.join(work, "epoch_2"),
                      "--device", "cpu"])
    got = res["detections"]
    files = os.listdir(work)
    assert "det_predictions.pkl" in files
    if name.startswith("nusc"):
        assert "nusc_det_results.json" in files
    assert len(got) == 2 and set(got) == set(want)
    for token, w in want.items():
        g = got[token]
        assert set(g) == set(w), token
        for k in ("label_preds", "valid"):
            np.testing.assert_array_equal(g[k], np.asarray(w[k]), k)
        for k in set(w) - {"label_preds", "valid"}:
            np.testing.assert_allclose(g[k], np.asarray(w[k]), atol=1e-4,
                                       err_msg=k)
        assert g["valid"].any()
        if name in ("nusc", "nusc_circle", "waymo_velo"):
            assert g["velocity"].shape == g["box3d_lidar"].shape[:1] + (2,)
