"""lidarseg3d_torch point-head ops and the MSeg3D fusion point head against
the JAX package: 3-NN devoxelization through the backbone's subm rulebook
(with the rank-order fallback for points whose voxel was dropped or lies
outside the grid), bilinear point-to-pixel sampling, and the whole
PointSegMSeg3DHead (evaluation) with Flax weights carried over.

Tolerances: fp32; interpolation and sampling max |err| <= 1e-5 * max
|reference|; the head (6 attention layers) 1e-4."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from __graft_entry__ import (_grid_shape, _mseg3d_model_cfg,
                             _synthetic_mseg3d_batch, PCR, VSZ)
from lidarseg3d_tpu.models import build_point_head as jbuild_head
from lidarseg3d_tpu.ops import grid_sample as jgs
from lidarseg3d_tpu.ops import interpolate as jinterp
from lidarseg3d_tpu.ops import sparse as jsp
from lidarseg3d_torch.convert import load_flax_variables
from lidarseg3d_torch.models import build_point_head as tbuild_head
from lidarseg3d_torch.ops import coords as tco
from lidarseg3d_torch.ops import grid_sample as tgs
from lidarseg3d_torch.ops import interpolate as tinterp
from lidarseg3d_torch.ops import sparse as tsp

from _torch_port_helpers import (assert_close_rel, init_shapes, n,
                                 random_variables, t)


@pytest.fixture(scope="module")
def scene():
    # capacity 1024 < the scans' voxel count: dropped voxels' points take
    # the rank-order fallback
    b = _synthetic_mseg3d_batch(2, 1024, 2048, img_hw=(64, 128), ncam=2,
                                seed=4)
    ishape = _grid_shape()
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(2, 1024, 16)).astype(np.float32)
    js = jsp.build_structure(jnp.asarray(b["coordinates"]),
                             jnp.asarray(b["num_voxels"]), ishape)
    ts = tsp.build_structure(t(b["coordinates"]), t(b["num_voxels"]), ishape)
    jt, tt = jsp.dense_table(js), tsp.dense_table(ts)
    jrb = jsp.build_subm_rulebook(js, table=jt)
    trb = tsp.build_subm_rulebook(ts, table=tt)
    return dict(b=b, feats=feats, js=js, ts=ts, jt=jt, tt=tt, jrb=jrb,
                trb=trb)


def test_grid_three_interpolate_matches_jax(scene):
    b = scene["b"]
    pts = b["points"][..., :3]
    pv = b["point_valid"]
    want = jinterp.grid_three_interpolate(
        jnp.asarray(pts), jnp.asarray(pv), scene["js"],
        jnp.asarray(scene["feats"]), VSZ, PCR, table=scene["jt"],
        subm_rulebook=scene["jrb"])
    got = tinterp.grid_three_interpolate(
        t(pts), t(pv), scene["ts"], t(scene["feats"]), VSZ, PCR,
        table=scene["tt"], subm_rulebook=scene["trb"])
    assert_close_rel(got, want, 1e-5, "interp")
    # some valid points have no active own voxel: the fallback ran
    own = tinterp._point_voxel_coords(t(pts), VSZ, PCR)
    _, found = tco.lookup_rank(scene["tt"], own, t(pv))
    assert int((~found & t(pv)).sum()) > 0


@pytest.mark.parametrize("ncam", [1, 3])
def test_sample_points_cuv_matches_jax(ncam):
    rng = np.random.default_rng(ncam)
    f = rng.normal(size=(2, ncam, 9, 13, 5)).astype(np.float32)
    cuv = np.zeros((2, 300, 4), np.float32)
    cuv[..., 0] = rng.random((2, 300)) < 0.7
    cuv[..., 1] = 2.0 * rng.integers(0, ncam, (2, 300)) / max(ncam - 1, 1) - 1
    cuv[..., 2:] = rng.uniform(-1.05, 1.05, (2, 300, 2))
    want = jgs.sample_points_cuv(jnp.asarray(f), jnp.asarray(cuv))
    got = tgs.sample_points_cuv(t(f), t(cuv))
    assert_close_rel(got, want, 1e-5, "sample")


def test_point_head_matches_jax(scene):
    b = scene["b"]
    cfg = _mseg3d_model_cfg(ratio=1)["point_head"]
    cfg = dict(cfg, voxel_size=tuple(VSZ), point_cloud_range=tuple(PCR))
    rng = np.random.default_rng(1)
    img = rng.normal(size=(4, 16, 32, 48)).astype(np.float32)
    cam_emb = rng.normal(size=(2, 20, 48)).astype(np.float32)
    jbatch = dict(
        conv_point_features=jnp.asarray(scene["feats"]),
        conv_structure=scene["js"], conv_table=scene["jt"],
        conv_subm_rulebook=scene["jrb"],
        point_valid=jnp.asarray(b["point_valid"]),
        points=jnp.asarray(b["points"]),
        points_cuv=jnp.asarray(b["points_cuv"]),
        image_features=jnp.asarray(img),
        camera_semantic_embeddings=jnp.asarray(cam_emb))
    jhead = jbuild_head(dict(cfg))
    v = random_variables(init_shapes(jhead, jbatch, train=False), seed=3)
    want = jax.jit(lambda v, bt: jhead.apply(v, bt, train=False))(v, jbatch)
    thead = tbuild_head(dict(cfg))
    load_flax_variables(thead, v)
    thead.eval()
    tbatch = dict(
        conv_point_features=t(scene["feats"]), conv_structure=scene["ts"],
        conv_table=scene["tt"], conv_subm_rulebook=scene["trb"],
        point_valid=t(b["point_valid"]), points=t(b["points"]),
        points_cuv=t(b["points_cuv"]), image_features=t(img),
        camera_semantic_embeddings=t(cam_emb))
    with torch.inference_mode():
        got = thead(tbatch)
    for k in ("voxel_logits", "point_features_camera",
              "point_features_pcamera", "out_logits"):
        assert_close_rel(got[k], want[k], 1e-4, k)
    np.testing.assert_array_equal(n(got["in_view"]), n(want["in_view"]))
