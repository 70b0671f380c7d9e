"""lidarseg3d_torch lidar branch against the JAX package: the
ImprovedMeanVFE descriptor and UNetSCN3D (r=1, V=2048) with Flax weights
carried over by lidarseg3d_torch.convert, including random BN running
statistics, so the batch_stats mapping and the nn.scan unstacking are
exercised.

Tolerance: fp32, max |err| <= 1e-4 * max |reference| after 36 convs and
BNs, each summing in another order than XLA."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from __graft_entry__ import PCR, VSZ, _grid_shape, _synthetic_batch
from lidarseg3d_tpu.models import build_backbone as jbuild_backbone
from lidarseg3d_tpu.models.readers.voxel_encoders import (
    _descriptor as jdescriptor)
from lidarseg3d_tpu.ops import sparse as jsp
from lidarseg3d_torch.convert import flax_to_state_dict, load_flax_variables
from lidarseg3d_torch.models import build_backbone as tbuild_backbone
from lidarseg3d_torch.models.readers.voxel_encoders import (
    _descriptor as tdescriptor)
from lidarseg3d_torch.ops import sparse as tsp

from _torch_port_helpers import (assert_close_rel, init_shapes, n,
                                 random_variables, t)

V, N = 2048, 2048
CFG = dict(type="UNetSCN3D", num_input_features=12, point_cloud_range=PCR,
           voxel_size=VSZ, model_cfg=dict(SCALING_RATIO=1))


@pytest.fixture(scope="module")
def run():
    b = _synthetic_batch(1, V, N, seed=11)
    ishape = _grid_shape()
    jfeat, _ = jdescriptor(jnp.asarray(b["voxels"]),
                           jnp.asarray(b["num_points"]))
    tfeat, _ = tdescriptor(t(b["voxels"]), t(b["num_points"]))

    junet = jbuild_backbone(dict(CFG))

    def st_of(feat, coords, num):
        return jsp.SparseTensor(
            structure=jsp.build_structure(coords, num, ishape),
            features=feat)

    args = (jfeat, jnp.asarray(b["coordinates"]), jnp.asarray(b["num_voxels"]))
    variables = random_variables(
        init_shapes(junet, st_of(*args), train=False), seed=0)

    @jax.jit
    def apply(v, feat, coords, num):
        out = junet.apply(v, st_of(feat, coords, num), train=False)
        return (out["conv_point_features"], out["conv_subm_rulebook"],
                out["multi_scale_3d_features"]["x_conv4"].features,
                out["multi_scale_3d_features"]["x_conv2"].features)

    want = apply(variables, *args)
    tunet = tbuild_backbone(dict(CFG))
    load_flax_variables(tunet, variables)
    tunet.eval()
    tst = tsp.SparseTensor(
        structure=tsp.build_structure(t(b["coordinates"]),
                                      t(b["num_voxels"]), ishape),
        features=tfeat)
    with torch.inference_mode():
        out = tunet(tst)
    got = (out["conv_point_features"], out["conv_subm_rulebook"],
           out["multi_scale_3d_features"]["x_conv4"].features,
           out["multi_scale_3d_features"]["x_conv2"].features)
    return dict(jfeat=jfeat, tfeat=tfeat, want=want, got=got, batch=b,
                variables=variables, tunet=tunet)


def test_vfe_descriptor_matches(run):
    assert run["tfeat"].shape[-1] == 12
    assert_close_rel(run["tfeat"], run["jfeat"], 1e-6, "descriptor")


def test_unet_matches_jax_with_converted_weights(run):
    nv = int(run["batch"]["num_voxels"][0])
    w_feat, w_rb, w_c4, w_c2 = run["want"]
    g_feat, g_rb, g_c4, g_c2 = run["got"]
    np.testing.assert_array_equal(n(g_rb), n(w_rb))
    assert g_feat.shape == (1, V, 16)
    assert np.isfinite(n(g_feat)).all()
    assert_close_rel(g_feat[:, :nv], n(w_feat)[:, :nv], 1e-4, "x_up1")
    assert_close_rel(g_c4, w_c4, 1e-4, "x_conv4")
    assert_close_rel(g_c2, w_c2, 1e-4, "x_up3")


def test_convert_is_strict(run):
    v = run["variables"]
    params = dict(v["params"])
    params.pop("SparseConvBNReLU_11")
    with pytest.raises(ValueError, match="not assigned"):
        flax_to_state_dict(run["tunet"], {"params": params,
                                          "batch_stats": v["batch_stats"]})
    params = dict(v["params"])
    params["Extra_0"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(ValueError, match="not consumed"):
        flax_to_state_dict(run["tunet"], {"params": params,
                                          "batch_stats": v["batch_stats"]})
