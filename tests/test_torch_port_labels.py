"""The labelled synthetic batch of lidarseg3d_torch.synthetic is bit-equal
to the JAX side's (__graft_entry__), key by key, and the port's own
encode_compact_value_labels equals the JAX package's."""

import numpy as np
import pytest

from __graft_entry__ import _synthetic_batch, _synthetic_mseg3d_batch
from lidarseg3d_tpu.core import voxelize as jvox
from lidarseg3d_torch import synthetic as syn
from lidarseg3d_torch.apis.train import DEVICE_BATCH_KEYS, example_to_device
from lidarseg3d_torch.core import voxelize as tvox


def _same(tb, jb):
    assert set(tb) == set(jb)
    for k in jb:
        if k == "metadata":
            continue
        assert tb[k].dtype == jb[k].dtype, k
        np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)


@pytest.mark.parametrize("B,ncam", [(1, 1), (2, 1), (1, 3)])
def test_labelled_mseg3d_batch_bit_equal(B, ncam):
    kw = dict(img_hw=(16, 32), ncam=ncam, seed=4, with_labels=True)
    jb = _synthetic_mseg3d_batch(B, 2048, 1536, **kw)
    tb = syn.synthetic_mseg3d_batch(B, 2048, 1536, **kw)
    _same(tb, jb)
    for k in ("voxel_sem_labels", "point_sem_labels", "images_sem_labels"):
        assert k in tb
    assert tb["images_sem_labels"].shape == (B * ncam, 16, 32)
    assert (tb["voxel_sem_labels"] > 0).any()


def test_labelled_lidar_batch_bit_equal():
    _same(syn.synthetic_batch(2, 1024, 1024, seed=9, with_labels=True),
          _synthetic_batch(2, 1024, 1024, seed=9, with_labels=True))


def test_encode_compact_value_labels():
    rng = np.random.default_rng(0)
    v = rng.integers(0, 4, size=(500, 5)).astype(np.int64)
    v[:50] = 0
    v[50:100] = v[50:100, :1]
    np.testing.assert_array_equal(tvox.encode_compact_value_labels(v),
                                  jvox.encode_compact_value_labels(v))
    np.testing.assert_array_equal(
        tvox.encode_compact_value_labels(v, ignore_id=3),
        jvox.encode_compact_value_labels(v, ignore_id=3))


def test_example_to_device_keeps_the_device_keys():
    from lidarseg3d_tpu.apis.train import DEVICE_BATCH_KEYS as JKEYS

    assert DEVICE_BATCH_KEYS == JKEYS
    b = syn.synthetic_mseg3d_batch(1, 512, 512, img_hw=(8, 8), seed=1,
                                   with_labels=True)
    ex = example_to_device(b, "cpu")
    assert set(ex) == set(DEVICE_BATCH_KEYS)
    assert "num_points_total" not in ex and "input_shape" not in ex
