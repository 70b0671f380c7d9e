"""Detect boxes in one Waymo frame (the port's counterpart of
tools/simple_inference_waymo.py, without a display).

    python -m lidarseg3d_torch.tools.simple_inference_waymo CONFIG
        --checkpoint WORK_DIR[/epoch_N] --frame FRAME.pkl|SCAN.bin
        [--out DETS.pkl] [--visual BEV.png] [--device cuda|cpu]

Reads one converted frame pkl (datasets/waymo/converter.py: the lidars'
``points_xyz`` and ``points_feature``) or a raw float32 ``.bin``,
voxelizes it with the config's voxel generator, runs the config's
detector (VoxelNet, PointPillars or TwoStageDetector; a two-stage
config's point width is its first stage's reader's, where the JAX tool
reads a ``reader`` the two-stage model does not have) from the
checkpoint, prints the valid boxes and saves them with ``--out``.
``--visual`` writes a bird's-eye PNG: the points grey, the boxes' outlines
red. The device is ``cuda`` unless ``--device cpu`` is given.
"""

import argparse
import os
import pickle
import time

import numpy as np

BEV_PIXEL = 0.1  # metres per pixel of the --visual image


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Detect boxes in one frame")
    p.add_argument("config")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--frame", required=True,
                   help="converted Waymo frame .pkl (or raw .bin, 5 "
                        "float32 columns)")
    p.add_argument("--out", default=None, help="output .pkl of detections")
    p.add_argument("--visual", default=None,
                   help="write a bird's-eye PNG to this path")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def load_points(path, num_features=5):
    """Frame pkl (converter format) or raw float32 .bin -> [N, F]."""
    if path.endswith(".bin"):
        return np.fromfile(path, dtype=np.float32).reshape(-1, num_features)
    with open(path, "rb") as f:
        obj = pickle.load(f)
    lid = obj["lidars"]
    pts = np.concatenate([np.asarray(lid["points_xyz"], np.float32),
                          np.asarray(lid["points_feature"], np.float32)],
                         axis=1)
    return pts[:, :num_features]


def reader_width(model_cfg):
    """The point width the config's reader takes (a two-stage model's:
    its first stage's)."""
    m = model_cfg.get("first_stage_cfg") or model_cfg
    return int(m["reader"].get("num_input_features", 5))


def draw_bev(points, boxes, extent):
    """uint8 BGR [H, W, 3] bird's-eye image of ``extent`` (x0, y0, x1, y1)
    at BEV_PIXEL m a pixel, +x right and +y up: points grey, box outlines
    red."""
    x0, y0, x1, y1 = extent
    W = int(round((x1 - x0) / BEV_PIXEL))
    H = int(round((y1 - y0) / BEV_PIXEL))
    img = np.zeros((H, W, 3), np.uint8)

    def put(xy, color):
        c = np.floor((xy[:, 0] - x0) / BEV_PIXEL).astype(np.int64)
        r = H - 1 - np.floor((xy[:, 1] - y0) / BEV_PIXEL).astype(np.int64)
        ok = (c >= 0) & (c < W) & (r >= 0) & (r < H)
        img[r[ok], c[ok]] = color

    put(points[:, :2], (128, 128, 128))
    t = np.linspace(0.0, 1.0, 64)[:, None]
    for b in boxes:
        x, y, _, l, w, _, yaw = b[:7]
        c, s = np.cos(yaw), np.sin(yaw)
        corners = np.array([[l, w], [l, -w], [-l, -w], [-l, w]]) / 2
        poly = corners @ np.array([[c, s], [-s, c]]) + [x, y]
        for i in range(4):
            a, e = poly[i], poly[(i + 1) % 4]
            put(a + t * (e - a), (0, 0, 255))
    return img


def main(argv=None):
    """-> dict of the valid boxes (box3d_lidar, scores, label_preds)."""
    from ..utils.config import Config
    from ..utils.device import resolve_device
    from .single_inference import infer, one_frame_batch
    from .test import load_model

    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = Config.fromfile(args.config)
    points = load_points(args.frame, reader_width(cfg.model))
    state = load_model(cfg, args.checkpoint, device)
    batch, ishape = one_frame_batch(cfg, points,
                                    os.path.basename(args.frame),
                                    max_points=len(points))
    t0 = time.time()
    out = infer(state, batch, ishape)
    out = {k: out[k][0].to("cpu").numpy()
           for k in ("box3d_lidar", "scores", "label_preds", "valid")}
    print(f"inference: {time.time() - t0:.2f}s, {len(points)} points")
    keep = out["valid"]
    dets = {"box3d_lidar": out["box3d_lidar"][keep],
            "scores": out["scores"][keep],
            "label_preds": out["label_preds"][keep]}
    names = list(cfg.get("class_names", []))
    print(f"{int(keep.sum())} detections:")
    for b, s, lab in zip(*dets.values()):
        name = names[int(lab)] if int(lab) < len(names) else str(int(lab))
        print(f"  {name:12s} score {s:.3f} "
              f"xyz=({b[0]:6.1f},{b[1]:6.1f},{b[2]:5.1f}) "
              f"lwh=({b[3]:.1f},{b[4]:.1f},{b[5]:.1f}) yaw={b[6]:.2f}")
    if args.out:
        with open(args.out, "wb") as f:
            pickle.dump(dets, f)
        print(f"saved {args.out}")
    if args.visual:
        from ..datasets.pipelines.png import write_png_bgr

        r = cfg.voxel_generator["range"]
        write_png_bgr(args.visual, draw_bev(points, dets["box3d_lidar"],
                                            (r[0], r[1], r[3], r[4])))
        print(f"saved {args.visual}")
    return dets


if __name__ == "__main__":
    main()
