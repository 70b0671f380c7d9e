"""Cylinder3D (SegPolarNet: the dynamic cylindrical VFE, the asymmetric
sparse UNet and the PolarNet head; and the _v2p variant with the batch-loss
head devoxelizing in cylindrical space) of lidarseg3d_torch against the
JAX package's, at a small size (grid 24x24x8, init_size 4, 600 voxels,
B=2, N=350), on the CPU: forward and predict, one train step (every loss
term, gradient, updated parameter and BN statistic), the voted voxel
labels and the reader's features and coordinates. Tolerances in
tests/_segpolar_parity.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lidarseg3d_tpu.models.readers import dynamic_vfe as jvfe
from lidarseg3d_tpu.ops import coords as jco
from lidarseg3d_tpu.ops import dynamic_voxel as jdv
from lidarseg3d_tpu.ops import sparse as jsp
from lidarseg3d_torch.convert import load_flax_variables
from lidarseg3d_torch.models.readers import dynamic_vfe as tvfe

import _segpolar_parity as P
from _torch_port_helpers import assert_close_rel, init_shapes, n, random_variables, t
from test_torch_port_support import one_torch_thread  # noqa: F401

GRID = (24, 24, 8)
NCLS = 6
READER = dict(type="Cylinder3DDynamicVoxelFeatureExtractor", grid_size=GRID,
              point_cloud_range=P.CYLR, average_points=False,
              num_input_features=5, num_output_features=32, fea_compre=8,
              max_voxels=600, voxel_label_enc="major", num_class=NCLS)


def cfg(variant):
    c = dict(
        type="SegPolarNet", reader=dict(READER),
        backbone=dict(type="Cylinder3D_Asymm_3d_spconv", output_shape=GRID,
                      num_input_features=8, nclasses=NCLS,
                      n_height=GRID[2], init_size=4),
        point_head=dict(type="PointSegPolarNetHead", class_agnostic=False,
                        num_class=NCLS, model_cfg=dict(IGNORED_LABEL=0)))
    if variant == "v2p":
        c["backbone"]["type"] = "Cylinder3D_Asymm_3d_spconv_v2p"
        c["point_head"] = dict(
            type="PointSegBatchlossHead", class_agnostic=False,
            num_class=NCLS,
            model_cfg=dict(CONV_IN_DIM=16, CONV_CLS_FC=[16],
                           CONV_ALIGN_DIM=16, OUT_CLS_FC=[16],
                           IGNORED_LABEL=0))
    return c


LOSSES = {"cyl": ("out_ce_loss", "out_lvsz_loss"),
          "v2p": ("conv_ce_loss", "conv_lovasz_loss", "out_ce_loss",
                  "out_lovasz_loss")}


@pytest.fixture(scope="module", params=["cyl", "v2p"])
def run(request):
    keys = (("out_logits",) if request.param == "cyl"
            else ("conv_logits", "out_logits"))
    return P.run(cfg(request.param), P.make_batch(2, 350, NCLS, seed=0),
                 keys)


def test_forward_and_predict_match(run):
    P.check_forward(run)


def test_loss_terms_and_grad_norm_match(run):
    P.check_losses(run, LOSSES["v2p" if "conv_logits" in run["out_keys"]
                               else "cyl"])


def test_every_gradient_matches(run):
    named = dict(run["tm"].named_parameters())
    assert any("ReconBlock_0.AsymmConvBNAct_0" in k for k in named)
    P.check_gradients(run)


def test_updated_parameters_and_bn_statistics_match(run):
    P.check_update(run, min_stats=80)


def test_reader_matches_jax():
    """The reader alone in training mode: the sparse structure, point
    coordinates and rows, voted voxel labels exactly; the voxel features
    within 1e-5."""
    batch = P.make_batch(2, 350, NCLS, seed=1)
    jr = jvfe.Cylinder3DDynamicVoxelFeatureExtractor(
        **{k: v for k, v in READER.items() if k != "type"})
    args = (jnp.asarray(batch["points"]), jnp.asarray(batch["point_valid"]),
            jnp.asarray(batch["point_sem_labels"]))
    v = random_variables(init_shapes(jr, *args, train=False), seed=2)
    want, _ = jax.jit(lambda v, *a: jr.apply(
        v, *a, train=True, mutable=["batch_stats"]))(v, *args)
    tr = tvfe.Cylinder3DDynamicVoxelFeatureExtractor(
        **{k: v for k, v in READER.items() if k != "type"})
    load_flax_variables(tr, jax.tree_util.tree_map(np.asarray, v))
    got = tr.train()(t(batch["points"]), t(batch["point_valid"]),
                     t(batch["point_sem_labels"]))
    js, ts = want["sparse_tensor"], got["sparse_tensor"]
    np.testing.assert_array_equal(n(ts.structure.coords),
                                  n(js.structure.coords))
    np.testing.assert_array_equal(n(ts.structure.num_voxels),
                                  n(js.structure.num_voxels))
    for k in ("point_vcoors", "point_voxel_rows", "voxel_sem_labels"):
        np.testing.assert_array_equal(n(got[k]), n(want[k]), k)
    assert_close_rel(ts.features, js.features, 1e-5, "voxel features")
    assert len(np.unique(n(got["voxel_sem_labels"]))) > 3


def test_reference_fault_12_the_rekeyed_structure_needs_sorting():
    """The _v2p branch re-keys the structure in (z, phi, r) order. Kept in
    its (r, phi, z) row order, as the JAX package keeps it, a table's rank
    is not a row: points' own-cell lookups on it return voxels at other
    coordinates. Sorted as the port sorts it, every found row is the
    point's voxel."""
    from lidarseg3d_torch.models.segmentors.seg_polarnet import rekey_reversed
    from lidarseg3d_torch.ops import sparse as tsp

    rng = np.random.default_rng(4)
    c = np.stack([rng.integers(0, g, (1, 500)) for g in GRID],
                 -1).astype(np.int32)
    valid = np.ones((1, 500), bool)
    js, _, _ = jdv.assign_points_to_voxels(jnp.asarray(c), jnp.asarray(valid),
                                           GRID, 600)
    rq = jnp.asarray(c[..., ::-1].copy())
    jrev = jsp.build_structure(js.coords[..., ::-1], js.num_voxels,
                               GRID[::-1])
    rows, found = jco.lookup_coords(jsp.dense_table(jrev), rq, GRID[::-1])
    got = np.asarray(jrev.coords)[0][np.asarray(rows)[0]]
    f = np.asarray(found)[0]
    assert (got[f] != c[0, :, ::-1][f]).any(axis=-1).mean() > 0.5
    ts = tsp.build_structure(t(np.asarray(js.coords)),
                             t(np.asarray(js.num_voxels)), GRID)
    _, trev = rekey_reversed(ts)
    rows, found = tsp.coord_ops.lookup_coords(tsp.dense_table(trev), t(rq),
                                              GRID[::-1])
    got = n(trev.coords)[0][n(rows)[0]]
    assert n(found).all()
    np.testing.assert_array_equal(got, c[0, :, ::-1])
