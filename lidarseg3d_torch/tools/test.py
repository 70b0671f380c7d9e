"""Evaluate a trained segmentor with the port: mIoU on val, the dataset's
submission files on test (the port's counterpart of tools/test.py).

    python -m lidarseg3d_torch.tools.test CONFIG --checkpoint WORK_DIR[/epoch_N]
        [--work_dir DIR] [--testset] [--speed_test] [--tta] [--batch_size N]
        [--device cuda|cpu] [--dist_coordinator HOST:PORT|URL
        --dist_num_processes N --dist_process_id I] [--dist_share_card]
    torchrun --nproc_per_node N -m lidarseg3d_torch.tools.test CONFIG ...

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
card.

On several processes (torchrun or the ``--dist_*`` flags, as
``tools.train``) each process evaluates its shard of the frames, TTA
variants with their frame, and counts the frames it owns: the histograms
are summed over the processes, so every frame counts once and every
process returns the mIoU of the whole split; rank 0 logs it, and on the
test split rank 0 gathers the predictions and writes the files.

Detection configs (VoxelNet, PointPillars, TwoStageDetector) take the
JAX tool's detection branch: ``apis.det_eval.run_det_eval`` decodes the
boxes (rotated or circle NMS and double flip as the config's
``test_cfg`` says; a two-stage model's refined boxes), the
prediction pkl ``WORK_DIR/det_predictions.pkl`` is written, the local
metrics (core/det_metrics.py: nuScenes mAP or Waymo AP / APH) are logged
when the ground truth covers every frame on the val split, and the
dataset's submission is written: the nuScenes results JSON, or Waymo's
Objects file (which needs waymo_open_dataset). On several processes rank
0 gathers every process's frames first, so each frame counts once.
"""

import argparse
import logging
import os
import sys

import numpy as np

from .train import add_dist_args, start_ranks


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
    add_dist_args(p)
    return p.parse_args(argv)


def _logger(main):
    """The tool's logger to stdout: INFO on rank 0, warnings elsewhere."""
    logger = logging.getLogger("lidarseg3d_torch.tools.test")
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter("%(message)s"))
        logger.addHandler(handler)
        logger.propagate = False
    logger.setLevel(logging.INFO if main else logging.WARNING)
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


DET_TYPES = ("VoxelNet", "PointPillars", "TwoStageDetector")


def model_config(cfg):
    """The config's model dict with its train_cfg and test_cfg, and for a
    detector the voxel grid its neck is sized for."""
    model_cfg = cfg.model.to_dict()
    for key in ("train_cfg", "test_cfg"):
        model_cfg.setdefault(key, dict(cfg.get(key) or {}))
    if model_cfg["type"] == "TwoStageDetector":
        model_cfg["first_stage_cfg"].setdefault("input_shape",
                                                input_shape_of(cfg))
    elif model_cfg["type"] in DET_TYPES:
        model_cfg.setdefault("input_shape", input_shape_of(cfg))
    return model_cfg


def load_model(cfg, checkpoint, device):
    """The config's model on ``device`` with the weights and BN statistics
    of ``checkpoint`` (a work dir, read through its ``latest.txt``, or
    ``WORK_DIR/epoch_N``) -> a weights-only TrainState."""
    from ..apis.train import TrainState, load_checkpoint
    from ..models import build_detector

    model = build_detector(model_config(cfg), device=device)
    state = TrainState(step=0, model=model, opt_state=None, generator=None)
    ckpt = checkpoint.rstrip("/")
    name = os.path.basename(ckpt)
    if name.startswith("epoch_"):
        load_checkpoint(os.path.dirname(ckpt), state,
                        epoch=int(name.split("_")[1]), partial=True)
    else:
        load_checkpoint(ckpt, state, partial=True)
    return state


def main(argv=None):
    """Run the evaluation; returns {"detections" (of the frames this
    process owns), "results" (the dataset's evaluation, None on the test
    split), "latencies" (seconds per frame of each batch under
    --speed_test), "state" (the loaded model's train state)}. A process
    group this call starts ends with it."""
    from ..parallel import dist

    args = parse_args(argv)
    owner = not dist.active()
    try:
        return _evaluate(args, *start_ranks(args)[:3])
    finally:
        if owner:
            dist.shutdown()


def _evaluate(args, rank, world, device):
    from ..apis.eval import evaluate_dataset, run_eval
    from ..datasets import SegDataLoader, build_dataset, default_worker_mode
    from ..utils.config import Config

    cfg = Config.fromfile(args.config)
    work_dir = args.work_dir or cfg.get("work_dir", ".")
    logger = _logger(rank == 0)

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
        num_hosts=world, host_id=rank,
        num_workers=cfg.data.get("workers_per_gpu", 4),
        worker_mode=default_worker_mode(cfg.data), drop_last=False)

    state = load_model(cfg, args.checkpoint, device)
    model = state.model
    logger.info("checkpoint loaded")

    if cfg.model["type"] in DET_TYPES:
        with loader:
            dets = _detect(args, cfg, dataset, ds_cfg, loader, state,
                           test_cfg, work_dir, logger)
        return {"detections": dets, "results": None, "latencies": [],
                "state": state}
    latencies = []
    with loader:
        dets = run_eval(model, state, loader, input_shape_of(cfg), dataset,
                        logger, test_cfg=test_cfg,
                        speed_test=args.speed_test, latencies=latencies)
    res = evaluate_dataset(dataset, dets, output_dir=work_dir,
                           testset=args.testset, logger=logger)
    return {"detections": dets, "results": res, "latencies": latencies,
            "state": state}


def _detect(args, cfg, dataset, ds_cfg, loader, state, test_cfg, work_dir,
            logger):
    """The detection branch (module docstring) -> this process's
    detections."""
    from ..apis.det_eval import (frame_ground_truth, run_det_eval,
                                 save_detections)
    from ..parallel import dist

    mine = run_det_eval(state.model, state, loader, input_shape_of(cfg),
                        logger, test_cfg=test_cfg)
    dets = mine
    if dist.world_size() > 1:
        parts = dist.gather_to_main(mine)
        if not dist.is_main_process():
            return mine
        dets = {k: v for part in parts for k, v in part.items()}
    os.makedirs(work_dir, exist_ok=True)
    pkl = save_detections(dets, os.path.join(work_dir,
                                             "det_predictions.pkl"))
    logger.info(f"wrote {pkl} ({len(dets)} frames)")
    ds_type = ds_cfg["type"]
    if not args.testset and cfg.get("class_names"):
        from ..core.det_metrics import (group_detections_by_class, nusc_map,
                                        waymo_ap)

        gts = frame_ground_truth(dataset, dets)
        if gts and len(gts) == len(dets):
            frames = group_detections_by_class(dets, gts,
                                               list(cfg["class_names"]))
            res = (nusc_map(frames) if ds_type == "SemanticNuscDataset"
                   else waymo_ap(frames))
            for k, v in res.items():
                logger.info(f"det metric {k}: {v}")
    if ds_type == "SemanticWaymoDataset":
        from ..datasets.waymo.det_submission import write_detection_objects

        try:
            out = write_detection_objects(dets, work_dir)
            logger.info(f"wrote {out} (evaluate with the official "
                        "compute_detection_metrics_main)")
        except ImportError as e:
            logger.warning(f"no Waymo Objects file: {e}")
    elif ds_type == "SemanticNuscDataset":
        from ..datasets.nuscenes.det_submission import (
            detections_to_nusc_json)

        infos = {i["token"]: i for i in dataset._infos}
        out = detections_to_nusc_json(
            dets, infos, os.path.join(work_dir, "nusc_det_results.json"))
        logger.info(f"wrote {out} (evaluate with "
                    "nuscenes.eval.detection.evaluate)")
    return dets


if __name__ == "__main__":
    main()
