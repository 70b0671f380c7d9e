"""The whole lidarseg3d_torch SegMSeg3DNet inference forward + predict
against the JAX package's, on _mseg3d_model_cfg(ratio=1, small_hrnet=True)
at a 64x128 camera and V=N=2048, with Flax weights (random, including BN
running statistics) carried over by lidarseg3d_torch.convert.

Tolerance: logits max |err| <= 1e-4 * max |reference logit| (fp32; every
stage sums in another order than XLA). Labels agree on >= 99.9% of the
valid points, and any disagreement sits where the reference's top two
logits are within that tolerance."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from __graft_entry__ import (_grid_shape, _mseg3d_model_cfg,
                             _synthetic_mseg3d_batch)
from lidarseg3d_tpu.models import build_detector as jbuild
from lidarseg3d_torch import synthetic as syn
from lidarseg3d_torch.convert import load_flax_variables
from lidarseg3d_torch.models import build_detector as tbuild

from _torch_port_helpers import assert_close_rel, init_shapes, n, random_variables

REL = 1e-4
V = N = 2048
IMG = (64, 128)


@pytest.fixture(scope="module")
def run():
    jb = _synthetic_mseg3d_batch(1, V, N, img_hw=IMG, seed=3)
    ishape = _grid_shape()
    jex = {k: jnp.asarray(v) for k, v in jb.items() if k != "metadata"}
    jm = jbuild(_mseg3d_model_cfg(ratio=1, small_hrnet=True, img_hw=IMG))

    def with_shape(e):
        e = dict(e)
        e["input_shape"] = ishape
        return e

    variables = random_variables(
        init_shapes(jm, with_shape(jex), train=False), seed=0)

    @jax.jit
    def fwd(v, e):
        ret, bat = jm.apply(v, with_shape(e), train=False)
        return ret["out_logits"], jm.predict(ret, bat)

    want_logits, want_pred = fwd(variables, jex)

    tb = syn.synthetic_mseg3d_batch(1, V, N, img_hw=IMG, seed=3)
    for k in ("voxels", "coordinates", "points", "points_cuv", "images"):
        np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
    tm = tbuild(syn.mseg3d_model_cfg(ratio=1, small_hrnet=True),
                device="cpu")
    load_flax_variables(tm, variables)
    ret, bat = tm(syn.example_to_device(tb, "cpu", syn.grid_shape()))
    pred = tm.predict(ret, bat)
    return dict(want_logits=want_logits, want_pred=want_pred, ret=ret,
                pred=pred, valid=jb["point_valid"])


def test_forward_logits_match(run):
    got = run["ret"]["out_logits"]
    assert tuple(got.shape) == (1, N, 20)
    assert_close_rel(got, run["want_logits"], REL, "out_logits")


def test_predict_labels_agree(run):
    valid = run["valid"]
    want = n(run["want_pred"]["pred_point_sem_labels"])
    got = n(run["pred"]["pred_point_sem_labels"])
    assert got.shape == (1, N)
    agree = (got == want)[valid]
    assert agree.mean() >= 0.999
    logits = n(run["want_logits"])
    top2 = np.sort(logits, axis=-1)[..., -2:]
    tol = REL * np.abs(logits).max()
    close = (top2[..., 1] - top2[..., 0]) <= 2 * tol
    assert np.all(close[valid][~agree])
    np.testing.assert_allclose(n(run["pred"]["point_softmax"]).sum(-1), 1.0,
                               rtol=1e-5)
