"""A segmented scan as a coloured bird's-eye image (the port's counterpart
of tools/visual.py; the PNG is written by
datasets/pipelines/png.write_png_bgr, the pixels and colours are the JAX
tool's).

    python -m lidarseg3d_torch.tools.visual --scan SCAN.bin
        --labels LABELS.npy [--out bev.png] [--num_features 4]
        [--extent 60] [--resolution 0.15]
"""

import argparse

import numpy as np


def label_colors(num_classes, seed=0):
    rng = np.random.default_rng(seed)
    colors = rng.integers(40, 255, (num_classes, 3), dtype=np.uint8)
    colors[0] = (40, 40, 40)
    return colors


def bev_image(pts, labels, extent, resolution):
    """-> (uint8 BGR image, points drawn): each point's pixel takes its
    label's colour (the last point wins)."""
    size = int(2 * extent / resolution)
    img = np.zeros((size, size, 3), np.uint8)
    xi = ((pts[:, 0] + extent) / resolution).astype(int)
    yi = ((pts[:, 1] + extent) / resolution).astype(int)
    ok = (xi >= 0) & (xi < size) & (yi >= 0) & (yi < size)
    colors = label_colors(int(labels.max()) + 1)
    img[size - 1 - yi[ok], xi[ok]] = colors[labels[ok]]
    return img, ok


def main(argv=None):
    from ..datasets.pipelines.png import write_png_bgr

    ap = argparse.ArgumentParser()
    ap.add_argument("--scan", required=True)
    ap.add_argument("--labels", required=True)
    ap.add_argument("--out", default="bev.png")
    ap.add_argument("--num_features", type=int, default=4)
    ap.add_argument("--extent", type=float, default=60.0)
    ap.add_argument("--resolution", type=float, default=0.15)
    args = ap.parse_args(argv)

    pts = np.fromfile(args.scan, np.float32).reshape(-1, args.num_features)
    labels = np.load(args.labels).astype(np.int64)
    n = min(len(pts), len(labels))
    pts, labels = pts[:n], labels[:n]
    img, ok = bev_image(pts, labels, args.extent, args.resolution)
    write_png_bgr(args.out, img)
    print(f"wrote {args.out} ({ok.sum()} points, "
          f"{len(np.unique(labels[ok]))} classes)")
    return args.out


if __name__ == "__main__":
    main()
