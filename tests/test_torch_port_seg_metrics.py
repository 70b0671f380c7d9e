"""The port's segmentation metrics (lidarseg3d_torch/core/seg_metrics.py)
against the JAX package's, exactly: fast_hist, per_class_iou,
fast_hist_crop and miou_from_hist on the same numpy inputs, and the
device histogram ``confusion_hist`` (one torch.bincount) against
``confusion_hist_jax``, over drawn shapes and class counts with the ignore
class, labels and predictions out of range, and a validity mask."""

import numpy as np
import jax
import jax.numpy as jnp
from hypothesis import given, settings
from hypothesis import strategies as st

from lidarseg3d_tpu.core import seg_metrics as J
from lidarseg3d_torch.core import seg_metrics as P

from _torch_port_helpers import n, t
from test_torch_port_support import one_torch_thread

_jax_hist = jax.jit(J.confusion_hist_jax, static_argnums=2)


@st.composite
def labelled(draw):
    C = draw(st.integers(2, 24))
    shape = tuple(draw(st.lists(st.integers(1, 40), min_size=1,
                                max_size=3)))
    seed = draw(st.integers(0, 2**31 - 1))
    rng = np.random.default_rng(seed)
    # out-of-range values on both sides: -1 and C..C+2
    label = rng.integers(-1, C + 3, shape).astype(np.int32)
    pred = rng.integers(-1, C + 3, shape).astype(np.int32)
    valid = rng.random(shape) < 0.8
    return C, label, pred, valid


@settings(max_examples=40, deadline=None, database=None)
@given(labelled())
def test_confusion_hist_matches_jax(case):
    C, label, pred, valid = case
    for v in (None, valid):
        want = np.asarray(_jax_hist(
            jnp.asarray(pred), jnp.asarray(label), C,
            None if v is None else jnp.asarray(v)))
        got = P.confusion_hist(t(pred), t(label), C,
                               valid=None if v is None else t(v))
        assert np.array_equal(n(got), want)


@settings(max_examples=60, deadline=None, database=None)
@given(labelled())
def test_numpy_metrics_match_jax(case):
    C, label, pred, _ = case
    pred_ok = np.clip(pred, 0, C - 1).reshape(-1)
    lab = label.reshape(-1)
    assert np.array_equal(P.fast_hist(pred_ok, lab, C),
                          J.fast_hist(pred_ok, lab, C))
    hist = J.fast_hist(pred_ok, lab, C)
    np.testing.assert_array_equal(P.per_class_iou(hist),
                                  J.per_class_iou(hist))
    got, want = P.miou_from_hist(hist), J.miou_from_hist(hist)
    assert got[0] == want[0] or (np.isnan(got[0]) and np.isnan(want[0]))
    np.testing.assert_array_equal(got[1], want[1])
    # the SemanticKITTI crop: classes 1..C-1, the ignore class 0 dropped
    unique = np.arange(1, C) - 1
    assert np.array_equal(P.fast_hist_crop(pred_ok, lab, unique),
                          J.fast_hist_crop(pred_ok, lab, unique))
