"""Segment one scan (the port's counterpart of tools/single_inference.py).

    python -m lidarseg3d_torch.tools.single_inference CONFIG
        --checkpoint WORK_DIR[/epoch_N] --scan SCAN.bin [--out LABELS.npy]
        [--device cuda|cpu]

Reads a raw float32 ``.bin`` scan (4 columns for a SemanticKITTI config,
else 5), voxelizes it with the config's voxel generator (its evaluation
capacity), runs the config's lidar-only segmentor (the SDSeg3D /
``SegNet`` configs) from the checkpoint, prints the points per predicted
class and saves the labels (int32 [N]) with ``--out``. The device is
``cuda`` unless ``--device cpu`` is given; the tool raises without a
card.
"""

import argparse
import os
import time

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Segment one scan")
    p.add_argument("config")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--scan", required=True, help=".bin point cloud file")
    p.add_argument("--out", default=None, help="output .npy of labels")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def one_frame_batch(cfg, points, token, max_points=None):
    """One scan voxelized by the config's generator at its evaluation
    capacity and collated -> (numpy batch, input_shape)."""
    from ..core.voxelize import VoxelGenerator
    from ..datasets.batching import collate_segnet
    from .test import input_shape_of

    vg_cfg = cfg.voxel_generator
    mv = vg_cfg["max_voxel_num"]
    max_voxels = mv[1] if isinstance(mv, (list, tuple)) else mv
    vg = VoxelGenerator(vg_cfg["voxel_size"], vg_cfg["range"],
                        vg_cfg["max_points_in_voxel"], max_voxels,
                        sort_by_key=vg_cfg.get("sort_by_key", True))
    voxels, coords, npts = vg.generate(points)
    frame = {"voxels": voxels, "coordinates": coords,
             "num_points_per_voxel": npts, "points": points,
             "metadata": {"token": token}}
    cap = cfg.get("capacity", {})
    batch = collate_segnet([frame], cap.get("max_voxels", 160000),
                           max_points or cap.get("max_points", 140000))
    return batch, input_shape_of(cfg)


def infer(state, batch, input_shape):
    """The model's evaluation forward and predict on a numpy batch."""
    import torch

    from ..apis.train import example_to_device

    model = state.model.eval()
    ex = example_to_device(batch, next(model.parameters()).device)
    ex["input_shape"] = input_shape
    with torch.inference_mode():
        return model.predict(*model(ex))


def main(argv=None):
    """-> the scan's labels (int32 [N])."""
    from ..utils.config import Config
    from ..utils.device import resolve_device
    from .test import load_model

    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = Config.fromfile(args.config)
    nfeat = 4 if "KITTI" in cfg.dataset_type else 5
    points = np.fromfile(args.scan, dtype=np.float32).reshape(-1, nfeat)
    state = load_model(cfg, args.checkpoint, device)
    batch, ishape = one_frame_batch(cfg, points, os.path.basename(args.scan))
    t0 = time.time()
    labels = infer(state, batch, ishape)["pred_point_sem_labels"][0]
    labels = labels[:len(points)].to("cpu").numpy().astype(np.int32)
    print(f"inference: {time.time() - t0:.2f}s, {len(points)} points")
    uniq, cnt = np.unique(labels, return_counts=True)
    for u, c in zip(uniq, cnt):
        print(f"  class {u}: {c} points")
    if args.out:
        np.save(args.out, labels)
        print(f"saved {args.out}")
    return labels


if __name__ == "__main__":
    main()
