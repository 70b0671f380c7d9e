"""Evaluate a trained segmentor with the port: mIoU on val, the dataset's
submission files on test (the port's counterpart of tools/test.py).

    python -m lidarseg3d_torch.tools.test CONFIG --checkpoint WORK_DIR[/epoch_N]
        [--work_dir DIR] [--testset] [--speed_test] [--tta] [--batch_size N]
        [--device cuda|cpu]

The model is built from the config, its weights and BN statistics loaded
from a checkpoint of ``apis.train.save_checkpoint`` (``WORK_DIR`` reads
``latest.txt``), and the config's val (or test) pipeline runs through the
port's dataset and loader into ``apis.eval.run_eval``; the mIoU and each
class's IoU are printed (``--testset`` writes the dataset's submission
files under the work dir instead). The loader takes the config's
``worker_mode``, else ``shm`` workers on a host with more than two CPUs.
``--tta`` evaluates with test-time augmentation, as the JAX tool does: a
SegCompoundAug stage (the config's ``tta_cfg``) goes in front of
SegVoxelization, which voxelizes every variant, each frame becomes
``num_tta_tranforms`` batch rows, and run_eval merges their softmax. A
config whose ``test_cfg`` sets ``tta_flag`` expects the variants, so it
fails without ``--tta``, as in the JAX package. The device is ``cuda``
unless ``--device cpu`` is given, and the tool raises when there is no
card. Not ported yet: the detection models and multi-process runs.
"""

import argparse
import logging
import os
import sys

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate a segmentor")
    p.add_argument("config")
    p.add_argument("--checkpoint", required=True,
                   help="work_dir (uses latest.txt) or work_dir/epoch_N")
    p.add_argument("--work_dir", default=None)
    p.add_argument("--testset", action="store_true")
    p.add_argument("--speed_test", action="store_true")
    p.add_argument("--tta", action="store_true")
    p.add_argument("--batch_size", default=1, type=int)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def _logger():
    logger = logging.getLogger("lidarseg3d_torch.tools.test")
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter("%(message)s"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


def input_shape_of(cfg):
    """(Z, Y, X) of the config's voxel grid, Z with one extra slab; None
    for a config without a host voxel generator (its model voxelizes the
    points itself: SegPolarNet's dynamic VFEs)."""
    if "voxel_generator" not in cfg:
        return None
    rng = np.asarray(cfg.voxel_generator["range"], np.float32)
    vs = np.asarray(cfg.voxel_generator["voxel_size"], np.float32)
    grid = np.round((rng[3:] - rng[:3]) / vs).astype(int)
    return (int(grid[2]) + 1, int(grid[1]), int(grid[0]))


def tta_dataset_cfg(ds_cfg, tta_cfg):
    """The dataset config with SegCompoundAug in front of SegVoxelization,
    whose config gets ``tta_flag`` and the ``tta_cfg`` keys (the JAX
    tool's --tta)."""
    pipe = []
    for st in ds_cfg["pipeline"]:
        if st["type"] == "SegVoxelization":
            pipe.append(dict(type="SegCompoundAug", cfg=dict(tta_cfg)))
            st = dict(st, cfg=dict(st["cfg"], tta_flag=True, **tta_cfg))
        pipe.append(st)
    return dict(ds_cfg, pipeline=pipe)


def main(argv=None):
    """Run the evaluation; returns {"detections", "results" (the dataset's
    evaluation, None on the test split), "latencies" (seconds per frame of
    each batch under --speed_test), "state" (the loaded model's train
    state)}."""
    args = parse_args(argv)
    from ..apis.eval import evaluate_dataset, run_eval
    from ..apis.train import TrainState, load_checkpoint
    from ..datasets import SegDataLoader, build_dataset, default_worker_mode
    from ..models import build_detector
    from ..utils.config import Config
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = Config.fromfile(args.config)
    work_dir = args.work_dir or cfg.get("work_dir", ".")
    logger = _logger()

    split = "test" if args.testset else "val"
    ds_cfg = cfg.data[split].to_dict()
    test_cfg = dict(cfg.get("test_cfg") or {})
    if args.tta:
        tta_cfg = cfg.get("tta_cfg")
        tta_cfg = (dict(num_tta_tranforms=4) if tta_cfg is None
                   else tta_cfg.to_dict())
        ds_cfg = tta_dataset_cfg(ds_cfg, tta_cfg)
        test_cfg["tta_flag"] = True
        test_cfg.setdefault("num_tta_tranforms", 4)
    dataset = build_dataset(ds_cfg)
    logger.info(f"{split} dataset: {len(dataset)} frames")
    cap = cfg.get("capacity", {})
    loader = SegDataLoader(
        dataset, batch_size=args.batch_size,
        max_voxels=cap.get("max_voxels", 160000),
        max_points=cap.get("max_points", 140000), shuffle=False,
        num_workers=cfg.data.get("workers_per_gpu", 4),
        worker_mode=default_worker_mode(cfg.data), drop_last=False)

    model_cfg = cfg.model.to_dict()
    for key in ("train_cfg", "test_cfg"):
        model_cfg.setdefault(key, dict(cfg.get(key) or {}))
    model = build_detector(model_cfg, device=device)
    state = TrainState(step=0, model=model, opt_state=None, generator=None)
    ckpt = args.checkpoint.rstrip("/")
    name = os.path.basename(ckpt)
    if name.startswith("epoch_"):
        load_checkpoint(os.path.dirname(ckpt), state,
                        epoch=int(name.split("_")[1]), partial=True)
    else:
        load_checkpoint(ckpt, state, partial=True)
    logger.info("checkpoint loaded")

    latencies = []
    with loader:
        dets = run_eval(model, state, loader, input_shape_of(cfg), dataset,
                        logger, test_cfg=test_cfg,
                        speed_test=args.speed_test, latencies=latencies)
    res = evaluate_dataset(dataset, dets, output_dir=work_dir,
                           testset=args.testset, logger=logger)
    return {"detections": dets, "results": res, "latencies": latencies,
            "state": state}


if __name__ == "__main__":
    main()
