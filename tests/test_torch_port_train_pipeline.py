"""The port's SemanticKITTI train pipeline against the JAX package's and
against cv2, on the CPU.

- The image label splat (``loading.splat_circles``) equals the JAX
  ``LoadImageAnnotations``' map (one ``cv2.circle`` per point) exactly, at
  radii 1, 2 and 3, with overlapping circles, circles cut by the border,
  centres outside the image and points with label 0.
- ``colorspace.bgr_to_hsv`` / ``hsv_to_bgr`` equal ``cv2.cvtColor``'s
  ``COLOR_BGR2HSV`` / ``COLOR_HSV2BGR`` exactly (tolerance 0 uint8 steps),
  and ``jpeg.jpeg_round_trip`` equals ``cv2.imdecode(cv2.imencode(".jpg",
  ...))`` exactly at qualities 30-70, at 1280x384 and at sizes that are not
  multiples of 16 (tolerance 0: the acceptance limit was 99.9% of the
  values equal and every value within 1 step). The colour jitter and the
  JPEG augmentation as the pipeline calls them equal the JAX package's
  (cv2) exactly and leave the generator in the same state.
- For every frame and several seeds, the port's train-mode
  ``dataset.get_sensor_data(i, rng)`` equals the JAX package's key by key,
  exactly (points, voxels, coordinates, num_points_per_voxel, both label
  arrays, points_cuv, the splatted and resized label maps and the
  normalized images: both sides normalize the same uint8 image with the
  same float32 operations), and both generators end in the same state: on
  configs/tests/mini_semkitti_mseg3d.py's train pipeline, and on a variant
  with the published radius 2, a random rescale and crop, an image width
  that is not a multiple of 32 and the ``major_value`` voxel labels. The
  tree's 1241x376 images take the projected points of a KITTI camera."""

import copy

import cv2
import numpy as np
import pytest

from lidarseg3d_tpu.core.voxelize import encode_major_value_labels as jmajor
from lidarseg3d_tpu.datasets import build_dataset as jbuild_dataset
from lidarseg3d_tpu.datasets.pipelines import img_transforms as JT
from lidarseg3d_tpu.datasets.pipelines import loading as jloading
from lidarseg3d_torch.core.voxelize import encode_major_value_labels
from lidarseg3d_torch.datasets import build_dataset
from lidarseg3d_torch.datasets.pipelines import img_transforms as T
from lidarseg3d_torch.datasets.pipelines import loading
from lidarseg3d_torch.datasets.pipelines.colorspace import (bgr_to_hsv,
                                                            hsv_to_bgr)
from lidarseg3d_torch.datasets.pipelines.jpeg import jpeg_round_trip
from lidarseg3d_torch.synthetic import _kitti_image, write_semantickitti_tree

from test_torch_port_support import mini_config, one_torch_thread

SHAPES = [(384, 1280), (376, 1241), (37, 53), (9, 7)]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("semkitti"))
    write_semantickitti_tree(root, sequences=("00",), frames=3,
                             points=(1200, 1500), seed=6,
                             image_hw=(376, 1241), max_range=6.0)
    return root


@pytest.mark.parametrize("radius", [1, 2, 3])
def test_circle_splat_equals_jax(radius):
    rng = np.random.default_rng(radius)
    H, W, n = 60, 90, 2500
    cp = np.full((n, 3), -100.0, np.float32)
    cp[:, 0] = rng.choice([1, 1, 1, 2], n)  # a few on another camera
    cp[:, 1] = rng.uniform(-4, W + 4, n)  # centres past the border too
    cp[:, 2] = rng.uniform(-4, H + 4, n)
    cp[:300, 1] = rng.uniform(20, 26, 300)  # a crowd: circles overlap
    cp[:300, 2] = rng.uniform(20, 26, 300)
    labels = rng.integers(0, 20, n).astype(np.int32)  # 0: not drawn
    info = {"cam": {"names": ["1"]}}

    def run(stage):
        sample = {"points_cp": cp, "images": [np.zeros((H, W, 3), np.uint8)],
                  "annotations": {"point_sem_labels": labels}}
        return stage(points_cp_radius=radius)(sample, info)[0][
            "image_sem_labels"][0]

    got = run(loading.LoadImageAnnotations)
    want = run(jloading.LoadImageAnnotations)
    assert got.dtype == want.dtype == np.uint8
    assert np.array_equal(got, want)
    assert (got > 0).mean() > 0.2 and got[0].any() and got[:, -1].any()


@pytest.mark.parametrize("shape", SHAPES + [(5, 31)])
def test_hsv_equals_cv2(shape):
    rng = np.random.default_rng(sum(shape))
    img = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    assert np.array_equal(bgr_to_hsv(img),
                          cv2.cvtColor(img, cv2.COLOR_BGR2HSV))
    hsv = np.stack([rng.integers(0, 180, shape), rng.integers(0, 256, shape),
                    rng.integers(0, 256, shape)], -1).astype(np.uint8)
    assert np.array_equal(hsv_to_bgr(hsv),
                          cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR))


@pytest.mark.parametrize("shape", SHAPES + [(2, 3)])
def test_jpeg_round_trip_equals_cv2(shape):
    rng = np.random.default_rng(sum(shape))
    images = [_kitti_image(rng, *shape),
              rng.integers(0, 256, shape + (3,), dtype=np.uint8)]
    for img in images:
        for q in (30, 41, 50, 57, 69, 70):
            ok, enc = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, q])
            assert ok
            want = cv2.imdecode(enc, cv2.IMREAD_COLOR)
            got = jpeg_round_trip(img, q)
            assert got.dtype == np.uint8 and got.shape == want.shape
            assert np.array_equal(got, want), (q, int((got != want).sum()))


@pytest.mark.parametrize("shape", [(384, 1280), (50, 100)])
def test_color_jitter_and_jpeg_augmentation_equal_jax(shape):
    for seed in range(4):
        img = _kitti_image(np.random.default_rng(seed), *shape)
        r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
        got = T.jpeg_compression(T.color_jitter(img, r1), r1, probability=1)
        want = JT.jpeg_compression(JT.color_jitter(img, r2), r2,
                                   probability=1)
        assert np.array_equal(got, want), seed
        assert r1.bit_generator.state == r2.bit_generator.state


def test_major_value_labels_equal_jax():
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 4, (500, 5))  # 0 = padding, ties common
    labels[:20] = 0
    assert np.array_equal(encode_major_value_labels(labels), jmajor(labels))


def _variant(published):
    """The mini config's train dataset, or a variant with the published
    radius 2, a random rescale and crop, a 100x50 image (100 is not a
    multiple of 32) and major_value voxel labels."""
    ds = copy.deepcopy(mini_config().data.train.to_dict())
    if published:
        ds["img_resized_shape"] = (100, 50)
        for st in ds["pipeline"]:
            if st["type"] == "LoadImageAnnotations":
                st["points_cp_radius"] = 2
            elif st["type"] == "SegImagePreprocess":
                st["cfg"]["random_rescale_cfg"] = dict(
                    scale_noise=(1.0, 1.5), probability=0.5)
                st["cfg"]["random_crop_cfg"] = dict(crop_shape=(40, 90))
            elif st["type"] == "SegAssignLabel":
                st["cfg"]["voxel_label_enc"] = "major_value"
    return ds


@pytest.mark.parametrize("published", [False, True],
                         ids=["mini", "radius2+rescale+crop+major"])
def test_train_frames_equal_jax(tree, published):
    cfg = _variant(published)
    cfg["root_path"] = tree
    ds, jds = build_dataset(copy.deepcopy(cfg)), jbuild_dataset(cfg)
    assert len(ds) == len(jds) == 3 and not ds.test_mode
    painted = 0
    for seed in range(4):
        for i in range(len(ds)):
            r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
            got, want = ds.get_sensor_data(i, r1), jds.get_sensor_data(i, r2)
            assert set(got) == set(want), set(got) ^ set(want)
            assert got["metadata"] == want["metadata"]
            for k, w in want.items():
                if k != "metadata":
                    assert got[k].dtype == w.dtype, k
                    assert np.array_equal(got[k], w), (seed, i, k)
            assert r1.bit_generator.state == r2.bit_generator.state
            painted += int((got["images_sem_labels"] > 0).sum())
    assert {"voxel_sem_labels", "point_sem_labels",
            "images_sem_labels"} <= set(got)
    assert painted > 0
