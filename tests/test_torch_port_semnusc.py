"""The whole lidarseg3d_torch SegMSeg3DNet inference forward + predict
against the JAX package's on the semnusc grid: the 0.1 m nuScenes range
(Z, Y, X) = (41, 1024, 1024), where stages 1-2 take KeyTables (the
sorted-keys merge lookup) and the point head devoxelizes on the sorted
branch. _mseg3d_model_cfg(num_class=17, ratio=1, small_hrnet=True), six
cameras at 64x96 (the 640x960 aspect; at 32x48 the 1/32 map is 1x2 against
2x3 at 1/16, an anisotropic upsample the JAX package's space-to-depth
fusion refuses), V=N=2048, fp32 image branch, Flax weights (random,
including BN running statistics) carried over by lidarseg3d_torch.convert.

Tolerance: logits max |err| <= 1e-4 * max |reference logit| (fp32; every
stage sums in another order than XLA). Labels agree on >= 99.9% of the
valid points, and any disagreement sits where the reference's top two
logits are within that tolerance."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from __graft_entry__ import _mseg3d_model_cfg, _synthetic_mseg3d_batch
from lidarseg3d_tpu.models import build_detector as jbuild
from lidarseg3d_torch import synthetic as syn
from lidarseg3d_torch.convert import load_flax_variables
from lidarseg3d_torch.models import build_detector as tbuild
from lidarseg3d_torch.ops import coords as tco
from lidarseg3d_torch.ops import sparse as tsp

from _torch_port_helpers import assert_close_rel, init_shapes, n, random_variables

REL = 1e-4
V = N = 2048
IMG = (64, 96)
NUSC = syn.SEMNUSC
PCR6, VSZ6, NCLS, NCAM = (NUSC["pcr"], NUSC["vsz"], NUSC["num_class"],
                          NUSC["ncam"])


@pytest.fixture(scope="module")
def run():
    ishape = syn.grid_shape(PCR6, VSZ6)
    jb = _synthetic_mseg3d_batch(1, V, N, img_hw=IMG, ncam=NCAM, seed=5,
                                 pcr=PCR6, vsz=VSZ6)
    jex = {k: jnp.asarray(v) for k, v in jb.items() if k != "metadata"}
    jm = jbuild(_mseg3d_model_cfg(num_class=NCLS, ratio=1, img_hw=IMG,
                                  small_hrnet=True, pcr=PCR6, vsz=VSZ6))

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

    tb = syn.synthetic_mseg3d_batch(1, V, N, img_hw=IMG, ncam=NCAM, seed=5,
                                    pcr=PCR6, vsz=VSZ6)
    for k in ("voxels", "coordinates", "points", "points_cuv", "images"):
        np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
    tm = tbuild(syn.mseg3d_model_cfg(num_class=NCLS, ratio=1,
                                     small_hrnet=True, pcr=PCR6, vsz=VSZ6),
                device="cpu")
    load_flax_variables(tm, variables)
    ex = syn.example_to_device(tb, "cpu", ishape)
    ret, bat = tm(ex)
    books = tm.backbone_mod.structures(tm.lidar_input(ex).structure)
    return dict(want_logits=want_logits, want_pred=want_pred, ret=ret,
                pred=tm.predict(ret, bat), valid=jb["point_valid"],
                books=books, ishape=ishape)


def test_semnusc_grid_takes_key_tables(run):
    assert run["ishape"] == (41, 1024, 1024)
    kinds = [type(run["books"][f"t{i}"]) for i in range(1, 5)]
    assert kinds == [tco.KeyTable, tco.KeyTable, tco.RankTable,
                     tco.RankTable]
    assert [tsp.table_kind(run["books"][f"s{i}"].spatial_shape)
            for i in range(1, 5)] == ["keys", "keys", "rank", "rank"]


def test_semnusc_forward_logits_match(run):
    got = run["ret"]["out_logits"]
    assert tuple(got.shape) == (1, N, NCLS)
    assert_close_rel(got, run["want_logits"], REL, "out_logits")


def test_semnusc_predict_labels_agree(run):
    valid = run["valid"]
    want = n(run["want_pred"]["pred_point_sem_labels"])
    got = n(run["pred"]["pred_point_sem_labels"])
    agree = (got == want)[valid]
    assert agree.mean() >= 0.999
    logits = n(run["want_logits"])
    top2 = np.sort(logits, axis=-1)[..., -2:]
    close = (top2[..., 1] - top2[..., 0]) <= 2 * REL * np.abs(logits).max()
    assert np.all(close[valid][~agree])
