"""lidarseg3d_torch's UNetCylinder3D against the JAX package's, on the
structure that the port's Cylinder3DDynamicVoxelFeatureExtractor builds
over a cylindrical (r, phi, z) grid of 32x24x16 cells (B=2, capacity 700,
points beyond the grid's radius clamped to its last ring, as the VFE
does), with the VFE's own features as the input:

- ``build_backbone(type="UNetCylinder3D")`` gives the UNetSCN3D
  architecture: the same state_dict keys and shapes, and with the same
  weights the same outputs, bit for bit;
- the JAX package builds the same structure from the VFE's cells
  (coordinates and counts exactly), and its UNetCylinder3D forward with
  the port's weights (random Flax variables, BN running statistics
  included, carried over by lidarseg3d_torch.convert) matches the port's
  within 1e-4 of max |JAX|, UNetSCN3D's limit (test_torch_port_unet.py:
  fp32 after 36 convs and BNs, each summing in another order than XLA)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidarseg3d_tpu.models import build_backbone as jbuild_backbone
from lidarseg3d_tpu.ops import dynamic_voxel as jdv
from lidarseg3d_tpu.ops import sparse as jsp
from lidarseg3d_torch.convert import load_flax_variables
from lidarseg3d_torch.models import build_backbone as tbuild_backbone
from lidarseg3d_torch.models import build_reader as tbuild_reader
from lidarseg3d_torch.models.layers import init_parameters

from _torch_port_helpers import (assert_close_rel, init_shapes, n,
                                 random_variables, t)

GRID = (32, 24, 16)  # (r, phi, z): the structure's (z, y, x) axes
CYL_RANGE = (0.0, -np.pi, -3.0, 8.0, np.pi, 3.0)
B, N, CAP = 2, 1500, 700
REL = 1e-4


def cfg(kind):
    return dict(type=kind, num_input_features=16,
                point_cloud_range=CYL_RANGE, voxel_size=(0.25, 0.26, 0.375),
                model_cfg=dict(SCALING_RATIO=1))


@pytest.fixture(scope="module")
def run():
    rng = np.random.default_rng(21)
    r = rng.uniform(0.5, 9.0, (B, N))  # past 8 m: the last ring
    phi = rng.uniform(-np.pi, np.pi, (B, N))
    pts = np.stack([r * np.cos(phi), r * np.sin(phi),
                    rng.uniform(-2.9, 2.9, (B, N)),
                    rng.uniform(0, 1, (B, N)), np.zeros((B, N))],
                   -1).astype(np.float32)
    valid = rng.random((B, N)) > 0.1
    vfe = tbuild_reader(dict(
        type="Cylinder3DDynamicVoxelFeatureExtractor", grid_size=GRID,
        point_cloud_range=CYL_RANGE, num_input_features=5, fea_compre=16,
        max_voxels=CAP)).eval()
    init_parameters(vfe, torch.Generator().manual_seed(3))
    with torch.inference_mode():
        out = vfe(t(pts), t(valid))
    st = out["sparse_tensor"]
    js, _, _ = jdv.assign_points_to_voxels(
        jnp.asarray(n(out["point_vcoors"])), jnp.asarray(valid), GRID, CAP)
    jst = jsp.SparseTensor(structure=js,
                           features=jnp.asarray(n(st.features)))

    junet = jbuild_backbone(cfg("UNetCylinder3D"))
    variables = random_variables(init_shapes(junet, jst, train=False),
                                 seed=4)

    @jax.jit
    def apply(v, s):
        o = junet.apply(v, s, train=False)
        return (o["conv_point_features"],
                o["multi_scale_3d_features"]["x_conv4"].features,
                o["multi_scale_3d_features"]["x_conv2"].features)

    models, got = {}, {}
    for kind in ("UNetCylinder3D", "UNetSCN3D"):
        m = tbuild_backbone(cfg(kind))
        load_flax_variables(m, variables)
        models[kind] = m.eval()
        with torch.inference_mode():
            o = m(st)
        got[kind] = (o["conv_point_features"],
                     o["multi_scale_3d_features"]["x_conv4"].features,
                     o["multi_scale_3d_features"]["x_conv2"].features)
    return dict(st=st, js=js, want=apply(variables, jst), got=got,
                models=models)


def test_cylinder_is_unet_scn3d_with_the_same_weights(run):
    cyl, scn = run["models"]["UNetCylinder3D"], run["models"]["UNetSCN3D"]
    assert type(cyl).__name__ == "UNetCylinder3D"
    assert isinstance(cyl, type(scn))
    a, b = cyl.state_dict(), scn.state_dict()
    assert list(a) == list(b)
    assert all(a[k].shape == b[k].shape for k in a)
    for x, y in zip(run["got"]["UNetCylinder3D"], run["got"]["UNetSCN3D"]):
        assert torch.equal(x, y)


def test_cylinder_matches_jax(run):
    st, js = run["st"], run["js"]
    np.testing.assert_array_equal(n(st.structure.coords), n(js.coords))
    np.testing.assert_array_equal(n(st.structure.num_voxels),
                                  n(js.num_voxels))
    nv = n(st.structure.num_voxels)
    assert nv.min() > 300 and (nv == CAP).any()  # a capacity overflow
    feat, c4, c2 = run["got"]["UNetCylinder3D"]
    w_feat, w_c4, w_c2 = run["want"]
    assert feat.shape == (B, CAP, 16) and np.isfinite(n(feat)).all()
    for b in range(B):
        assert_close_rel(feat[b, :nv[b]], n(w_feat)[b, :nv[b]], REL,
                         f"x_up1 b={b}")
    assert_close_rel(c4, w_c4, REL, "x_conv4")
    assert_close_rel(c2, w_c2, REL, "x_up3")
