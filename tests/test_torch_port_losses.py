"""lidarseg3d_torch.ops.losses against lidarseg3d_tpu/ops/losses.py: value
and gradient of cross_entropy and lovasz_softmax with ignored labels,
padding rows and an absent class.

Tolerance: fp32, values within 1e-5 relative, gradients within 1e-5 of
the largest reference gradient entry (cumulative sums in another order).
The probabilities are drawn without ties, so the sort order, and with it
the per-element Lovász gradient, is the same on both sides; a second case
pins the order of ties (the stable descending sort). The image head's
get_loss (bilinear upsample to the label resolution, weighted CE and
Lovász) is held the same way, its gradient within 1e-4 (it sums through
the upsampling)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lidarseg3d_tpu.ops import losses as JL
from lidarseg3d_torch.ops import losses as TL

from _torch_port_helpers import assert_close_rel, t

REL = 1e-5
N, C = 300, 7


def _case(seed, absent=5):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 2, size=(N, C)).astype(np.float32)
    labels = rng.integers(0, C, size=N).astype(np.int32)
    labels[labels == absent] = 1  # class `absent` never occurs
    valid = np.arange(N) < N - 40  # trailing padding rows
    return logits, labels, valid


def _grad_pair(jf, tf, logits):
    jv, jg = jax.value_and_grad(jf)(jnp.asarray(logits))
    x = t(logits).requires_grad_(True)
    tv = tf(x)
    tv.backward()
    return jv, jg, tv, x.grad


@pytest.mark.parametrize("use_valid", [True, False])
def test_cross_entropy(use_valid):
    logits, labels, valid = _case(0)
    jvalid = jnp.asarray(valid) if use_valid else None
    tvalid = t(valid) if use_valid else None
    jv, jg, tv, tg = _grad_pair(
        lambda x: JL.cross_entropy(x, jnp.asarray(labels), 0, valid=jvalid),
        lambda x: TL.cross_entropy(x, t(labels), 0, valid=tvalid), logits)
    assert_close_rel(tv, jv, REL, "value")
    assert_close_rel(tg, jg, REL, "gradient")


def test_cross_entropy_all_ignored_is_zero():
    logits, labels, _ = _case(1)
    v = TL.cross_entropy(t(logits), torch.zeros(N, dtype=torch.int32), 0)
    assert float(v) == 0.0


@pytest.mark.parametrize("ignore,use_valid,classes", [
    (0, True, "present"), (None, True, "present"), (0, False, "present"),
    (0, True, "all")])
def test_lovasz_softmax(ignore, use_valid, classes):
    logits, labels, valid = _case(2)
    jvalid = jnp.asarray(valid) if use_valid else None
    tvalid = t(valid) if use_valid else None
    jv, jg, tv, tg = _grad_pair(
        lambda x: JL.lovasz_softmax(jax.nn.softmax(x, -1),
                                    jnp.asarray(labels), ignore=ignore,
                                    valid=jvalid, classes=classes),
        lambda x: TL.lovasz_softmax(torch.softmax(x, -1), t(labels),
                                    ignore=ignore, valid=tvalid,
                                    classes=classes), logits)
    assert_close_rel(tv, jv, REL, "value")
    assert_close_rel(tg, jg, REL, "gradient")


def test_lovasz_ties_fall_as_in_jax():
    """Equal errors: the gradient with respect to the probabilities
    depends on which of the tied elements comes first."""
    rng = np.random.default_rng(3)
    probas = np.full((40, 3), 1.0 / 3.0, np.float32)  # every error ties
    labels = rng.integers(0, 3, size=40).astype(np.int32)
    valid = np.arange(40) < 33
    jg = jax.grad(lambda p: JL.lovasz_softmax(
        p, jnp.asarray(labels), ignore=0, valid=jnp.asarray(valid)))(
            jnp.asarray(probas))
    p = t(probas).requires_grad_(True)
    TL.lovasz_softmax(p, t(labels), ignore=0, valid=t(valid)).backward()
    assert_close_rel(p.grad, jg, REL, "gradient under ties")


@pytest.mark.parametrize("lovasz_weight", [-1.0, 0.3])
def test_image_head_get_loss_matches_jax(lovasz_weight):
    from lidarseg3d_tpu.models.img_heads.fcn_mseg3d_head import (
        FCNMSeg3DHead as JHead)
    from lidarseg3d_torch.models.img_heads.fcn_mseg3d_head import (
        FCNMSeg3DHead as THead)

    rng = np.random.default_rng(4)
    logits = rng.normal(0, 2, size=(2, 6, 8, C)).astype(np.float32)  # NHWC
    labels = rng.integers(0, C, size=(2, 24, 32)).astype(np.int32)
    kw = dict(num_classes=C, ignore_index=0, loss_weight=0.5,
              lovasz_loss_weight=lovasz_weight)
    jh = JHead(**kw)
    th = THead(in_channels=(4,), in_index=(0,), channels=8, num_convs=1,
               concat_input=False, **kw)

    def jf(x):
        return jh.get_loss({"image_logits": x},
                           {"images_sem_labels": jnp.asarray(labels)})

    (jv, jd), jg = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(logits))
    x = t(logits).requires_grad_(True)
    tv, td = th.get_loss({"image_logits": x},
                         {"images_sem_labels": t(labels)})
    tv.backward()
    assert set(td) == set(jd)
    assert ("image_lvsz_loss" in td) == (lovasz_weight > 0)
    for k in jd:
        assert_close_rel(td[k], jd[k], REL, k)
    assert_close_rel(tv, jv, REL, "value")
    assert_close_rel(x.grad, jg, 10 * REL, "gradient")
