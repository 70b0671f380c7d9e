"""The port's CenterPoint detectors and UNetSCN3D's encoded tensor
against the JAX package's, with the same seeded numpy inputs and Flax
variables (convert.py):

- PointPillars (the Waymo PP config's model cut to 16 wide) forward,
  predict, loss and BN statistics within 1e-4, labels and valid flags
  exact (VoxelNet's forward and predict: the tools against JAX's
  run_det_eval, test_torch_port_det_entry.py; its loss and step:
  test_torch_port_det_train.py);
- UNetSCN3D with RETURN_ENCODED_TENSOR (its extra conv and the decoder's
  renamed convs).

The JAX side runs under jax.jit."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import torch

from lidarseg3d_tpu.models import build_backbone as jbackbone
from lidarseg3d_tpu.models import build_detector as jbuild
from lidarseg3d_tpu.ops import sparse as jsp
from lidarseg3d_torch.apis.train import example_to_device
from lidarseg3d_torch.convert import flax_to_state_dict, load_flax_variables
from lidarseg3d_torch.models import build_backbone as tbackbone
from lidarseg3d_torch.models import build_detector as tbuild
from lidarseg3d_torch.ops import sparse as tsp

from test_torch_port_support import one_torch_thread  # noqa: F401
from test_torch_port_det_support import det_batch, grid, pointpillars_cfg
from _torch_port_helpers import (assert_close_rel, init_shapes, n,
                                 random_variables, t)

REL = 1e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_example(batch, ishape):
    ex = {k: jnp.asarray(v) for k, v in batch.items()
          if k not in ("metadata", "det_targets")}
    ex["det_targets"] = [{k: jnp.asarray(v) for k, v in g.items()}
                         for g in batch["det_targets"]]
    return ex


def test_pointpillars_forward_loss_predict():
    cfg, pcr, vsz, tids = pointpillars_cfg()
    batch = det_batch(2, pcr, vsz, tids, seed=7, points_per_voxel=20,
                      max_voxels=3000, out_factor=1)
    ishape = grid(pcr, vsz)
    jm = jbuild(copy.deepcopy(cfg))
    jex = _jax_example(batch, ishape)
    var = random_variables(init_shapes(jm, dict(jex, input_shape=ishape),
                                       train=False), seed=8)

    def fwd(v, e):
        r, b = jm.apply(v, dict(e, input_shape=ishape), train=False)
        return r, jm.predict(r, b)

    def loss(v, e):
        (r, b), st = jm.apply(v, dict(e, input_shape=ishape), train=True,
                              mutable=["batch_stats"])
        return jm.loss(r, b), st

    jr, jp = jax.jit(fwd)(var, jex)
    tm = tbuild(copy.deepcopy(cfg), device="cpu")
    load_flax_variables(tm, _np(var))
    ex = example_to_device(batch, "cpu")
    ex["input_shape"] = ishape
    tr, tb = tm.eval()(ex)
    tp = tm.predict(tr, tb)
    for a, b in zip(jr, tr):
        for k in a:
            assert_close_rel(n(b[k]).transpose(0, 2, 3, 1), a[k], REL, k)
    for k in ("label_preds", "valid"):
        np.testing.assert_array_equal(n(tp[k]), np.asarray(jp[k]), k)
    for k in ("box3d_lidar", "scores"):
        np.testing.assert_allclose(n(tp[k]), np.asarray(jp[k]), atol=1e-4,
                                   err_msg=k)
    assert int(n(tp["valid"]).sum()) > 0
    (jl, jld), jst = jax.jit(loss)(var, jex)
    tm.train()
    tr, tb = tm(ex)
    tl, tld = tm.loss(tr, tb)
    assert set(tld) == set(jld)
    for k in jld:
        assert_close_rel(tld[k], jld[k], REL, k)
    want = flax_to_state_dict(tm, {"params": _np(var["params"]),
                                   "batch_stats": _np(jst["batch_stats"])})
    for k, v in tm.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            assert_close_rel(v, want[k], REL, k)


def test_unet_encoded_tensor():
    from __graft_entry__ import _synthetic_batch
    from lidarseg3d_torch import synthetic as syn

    pcr = (-6.4, -6.4, -4.0, 6.4, 6.4, 2.0)
    b = _synthetic_batch(2, 2048, 3000, seed=9, pcr=pcr)
    ishape = syn.grid_shape(pcr)
    cfg = dict(type="UNetSCN3D", num_input_features=4,
               point_cloud_range=pcr, voxel_size=syn.VSZ,
               model_cfg=dict(RETURN_ENCODED_TENSOR=True, SCALING_RATIO=1))
    jm = jbackbone(copy.deepcopy(cfg))
    feats = np.asarray(b["voxels"]).mean(axis=2)

    def japply(v, coords, nums, f):
        st = jsp.SparseTensor(structure=jsp.build_structure(
            coords, nums, ishape), features=f)
        out = jm.apply(v, st, train=False)
        e = out["encoded_spconv_tensor"]
        return (e.features, e.structure.coords, e.structure.num_voxels,
                out["conv_point_features"])

    args = [jnp.asarray(b["coordinates"]), jnp.asarray(b["num_voxels"]),
            jnp.asarray(feats)]
    st = jsp.SparseTensor(structure=jsp.build_structure(args[0], args[1],
                                                        ishape),
                          features=args[2])
    var = random_variables(init_shapes(jm, st, train=False), seed=10)
    assert "SparseConvBNReLU_12" in var["params"]
    jf, jc, jn, jp = jax.jit(japply)(var, *args)
    tm = tbackbone(copy.deepcopy(cfg))
    load_flax_variables(tm, _np(var))
    tst = tsp.SparseTensor(tsp.build_structure(t(np.asarray(b[
        "coordinates"])), t(np.asarray(b["num_voxels"])), ishape),
        t(feats))
    with torch.inference_mode():
        out = tm.eval()(tst)
    enc = out["encoded_spconv_tensor"]
    assert out["encoded_spconv_tensor_stride"] == 8
    np.testing.assert_array_equal(n(enc.structure.coords), np.asarray(jc))
    np.testing.assert_array_equal(n(enc.structure.num_voxels),
                                  np.asarray(jn))
    assert_close_rel(enc.features, jf, REL, "encoded")
    assert_close_rel(out["conv_point_features"], jp, REL, "decoder")


def test_center_head_vel():
    """CenterHead's velocity head under double flip against JAX's (test_torch_port_det_head.py
    ``center_head_case``)."""
    from test_torch_port_det_head import center_head_case

    center_head_case("vel")
