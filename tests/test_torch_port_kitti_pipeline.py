"""The port's SemanticKITTI evaluation pipeline against the JAX package's,
on a seeded tree from synthetic.write_semantickitti_tree (two frames of
1,200-1,500 points within 6 m, 64x128 PNGs) and the val pipeline of
configs/tests/mini_semkitti_mseg3d.py.

- The PNG reader (zlib + numpy) equals ``cv2.imread`` exactly, on files
  whose rows use each of the five PNG filters, on a file cv2 wrote, and on
  the tree's own files; it refuses 16-bit and grey PNGs.
- The bilinear resize (cv2's fixed point in numpy) equals
  ``cv2.resize(..., INTER_LINEAR)`` exactly (tolerance 0 uint8 steps),
  at KITTI's 1241x376 -> 1280x384, at nuScenes' 1600x900 -> 960x640 and
  at smaller up- and downscales; the nearest resize equals INTER_NEAREST.
- For every frame, the port's ``dataset[i]`` equals the JAX package's key
  by key, exactly (points, voxels, coordinates, num_points_per_voxel,
  points_cuv and the normalized images: both sides normalize the same
  uint8 image with the same float32 operations), and the loaded points
  and ``points_cp`` equal the JAX LoadPointCloudFromFile's."""

import os
import struct
import zlib

import cv2
import numpy as np
import pytest

from lidarseg3d_tpu.datasets import build_dataset as jbuild_dataset
from lidarseg3d_tpu.datasets.pipelines import loading as jloading
from lidarseg3d_torch.datasets import build_dataset
from lidarseg3d_torch.datasets.pipelines import img_transforms as T
from lidarseg3d_torch.datasets.pipelines import loading
from lidarseg3d_torch.datasets.pipelines.png import (read_png_bgr,
                                                     write_png_bgr)
from lidarseg3d_torch.synthetic import write_semantickitti_tree

from test_torch_port_support import mini_val_dataset_cfg, one_torch_thread


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("semkitti"))
    write_semantickitti_tree(root, sequences=("00",), frames=2,
                             points=(1200, 1500), seed=3,
                             image_hw=(64, 128), max_range=6.0)
    return root


def _filtered_png(path, rgb, kinds):
    """Write rgb uint8 [H, W, 3] as a PNG whose row y uses filter
    kinds[y % len(kinds)] (the encoder of the PNG specification)."""
    H, W = rgb.shape[:2]
    raw = rgb.reshape(H, W * 3).astype(np.int64)
    rows = []
    for y in range(H):
        k = kinds[y % len(kinds)]
        x = raw[y]
        up = raw[y - 1] if y else np.zeros_like(x)
        left = np.concatenate([np.zeros(3, np.int64), x[:-3]])
        ul = np.concatenate([np.zeros(3, np.int64), up[:-3]])
        if k == 0:
            pred = np.zeros_like(x)
        elif k == 1:
            pred = left
        elif k == 2:
            pred = up
        elif k == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        rows.append(bytes([k]) + ((x - pred) % 256).astype(np.uint8)
                    .tobytes())

    def chunk(kind, body):
        return (len(body).to_bytes(4, "big") + kind + body
                + zlib.crc32(kind + body).to_bytes(4, "big"))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(b"".join(rows)))
                + chunk(b"IEND", b""))


def test_png_reader_equals_cv2_imread(tmp_path, tree):
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:37, 0:53]
    smooth = np.stack([xx * 4, yy * 6, xx + yy], -1) % 256
    noisy = rng.integers(0, 256, (37, 53, 3))
    for name, img in (("smooth", smooth), ("noisy", noisy)):
        rgb = img.astype(np.uint8)
        for kinds in ([0], [1], [2], [3], [4], [0, 1, 2, 3, 4]):
            p = str(tmp_path / f"{name}_{''.join(map(str, kinds))}.png")
            _filtered_png(p, rgb, kinds)
            got = read_png_bgr(p)
            assert np.array_equal(got, cv2.imread(p)), (name, kinds)
            assert np.array_equal(got, rgb[..., ::-1]), (name, kinds)
    p = str(tmp_path / "by_cv2.png")
    cv2.imwrite(p, noisy.astype(np.uint8))
    assert np.array_equal(read_png_bgr(p), cv2.imread(p))
    p = str(tmp_path / "own.png")
    write_png_bgr(p, noisy.astype(np.uint8))
    assert np.array_equal(cv2.imread(p), noisy)
    for f in sorted(os.listdir(os.path.join(tree, "00", "image_2"))):
        p = os.path.join(tree, "00", "image_2", f)
        assert np.array_equal(read_png_bgr(p), cv2.imread(p))
    for bad in (np.zeros((4, 5, 3), np.uint16), np.zeros((4, 5), np.uint8)):
        p = str(tmp_path / "bad.png")
        cv2.imwrite(p, bad)
        with pytest.raises(ValueError, match="8-bit RGB"):
            read_png_bgr(p)


@pytest.mark.parametrize("src,dst", [((376, 1241), (384, 1280)),
                                     ((64, 128), (64, 128)),
                                     ((37, 101), (64, 128)),
                                     ((376, 1241), (64, 128)),
                                     ((900, 1600), (640, 960))])
def test_resize_equals_cv2(src, dst):
    rng = np.random.default_rng(sum(src) + sum(dst))
    img = rng.integers(0, 256, src + (3,), dtype=np.uint8)
    (H1, W1) = dst
    want = cv2.resize(img, (W1, H1), interpolation=cv2.INTER_LINEAR)
    assert np.array_equal(T.resize_linear_u8(img, W1, H1), want)
    lab = rng.integers(0, 20, src, dtype=np.uint8)
    assert np.array_equal(
        T.resize_nearest(lab, W1, H1),
        cv2.resize(lab, (W1, H1), interpolation=cv2.INTER_NEAREST))


def test_loaded_points_and_projections_equal_jax(tree):
    ds = build_dataset(mini_val_dataset_cfg(tree))
    for i in range(len(ds)):
        info = ds.load_infos(i)
        got, _ = loading.LoadPointCloudFromFile(use_img=True)({}, info)
        want, _ = jloading.LoadPointCloudFromFile(use_img=True)(
            {}, dict(info))
        assert np.array_equal(got["points"], want["points"])
        assert np.array_equal(got["points_cp"], want["points_cp"])
        assert (got["points_cp"][:, 0] > 0).sum() > 0


def test_dataset_frames_equal_jax(tree):
    ds = build_dataset(mini_val_dataset_cfg(tree))
    jds = jbuild_dataset(mini_val_dataset_cfg(tree))
    assert len(ds) == len(jds) == 2
    assert ds.frame_names == jds.frame_names
    for i in range(len(ds)):
        got, want = ds[i], jds[i]
        assert set(got) == set(want), (set(got) ^ set(want))
        assert got["metadata"] == want["metadata"]
        for k in ("points", "voxels", "coordinates", "num_points_per_voxel",
                  "points_cuv", "images"):
            assert got[k].dtype == want[k].dtype, k
            assert np.array_equal(got[k], want[k]), k
        assert len(got["coordinates"]) > 100
