"""The port's CenterPoint modules against the JAX package's, with the same
seeded numpy inputs and Flax variables (convert.py):

- SpMiddleResNetFHD on a RankTable and on a KeyTable run: every
  structure and rulebook of the chain (the three stride-2 stages, stage
  4's padding (0, 1, 1), the extra (3, 1, 1) conv of stride (2, 1, 1) and
  padding 0, the inverse rulebooks) equal; the BEV map (RankTable run)
  within 1e-4; the
  BEV width at both published grids (41 x 1024 x 1024 and 41 x 1504 x
  1504) is 3 x 128 = 384 in both packages (the configs say 256); the
  inverse rulebooks are built only when gradients are recorded;
- the RPN of the VoxelNet configs (upsample kernel 2) and of the
  PointPillars config (kernels 2 and 4; the transposed kernels flipped by
  convert.py) within 1e-5;

The JAX side runs under jax.jit (Pallas in its XLA reference on the
CPU). CenterHead: test_torch_port_det_head.py; the detectors and
UNetSCN3D's encoded tensor: test_torch_port_det_detector.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidarseg3d_tpu.models import build_backbone as jbackbone
from lidarseg3d_tpu.models import build_neck as jneck
from lidarseg3d_tpu.ops import sparse as jsp
from lidarseg3d_torch.convert import flax_to_state_dict, load_flax_variables
from lidarseg3d_torch.models import build_backbone as tbackbone
from lidarseg3d_torch.models import build_neck as tneck
from lidarseg3d_torch.models.backbones.scn_det import SpMiddleResNetFHD
from lidarseg3d_torch.ops import sparse as tsp

from test_torch_port_support import one_torch_thread  # noqa: F401
from test_torch_port_det_support import (det_batch, grid, pointpillars_cfg,
                                         voxelnet_cfg)
from _torch_port_helpers import (assert_close_rel, init_shapes, n,
                                 random_variables, t)

REL = 1e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_chain(s1, V, caps=(0.5, 0.25, 0.15, 0.15)):
    """SpMiddleResNetFHD's structures and rulebooks in the JAX package's
    order (scn_det.py)."""
    out = {}
    t1 = jsp.dense_table(s1)
    out["subm1"] = jsp.build_subm_rulebook(s1, table=t1)
    s, tab = s1, t1
    for i, pad in enumerate((1, 1, (0, 1, 1))):
        n_ = i + 2
        so = jsp.downsample_structure(s, 2, max(1, int(V * caps[i])))
        out[f"down{n_}"] = jsp.build_strided_rulebook(s, so, 3, 2, pad,
                                                      table=tab)
        to = jsp.dense_table(so)
        out[f"inv{n_}"] = jsp.build_inverse_rulebook(so, s, 3, 2, pad,
                                                     table=to)
        out[f"subm{n_}"] = jsp.build_subm_rulebook(so, table=to)
        out[f"s{n_}"] = so
        s, tab = so, to
    s5 = jsp.downsample_structure(s, (2, 1, 1), max(1, int(V * caps[3])))
    out["down5"] = jsp.build_strided_rulebook(s, s5, (3, 1, 1), (2, 1, 1), 0,
                                              table=tab)
    out["inv5"] = jsp.build_inverse_rulebook(s5, s, (3, 1, 1), (2, 1, 1), 0)
    out["s5"] = s5
    for k in [k for k in out if isinstance(out[k], jsp.SparseStructure)]:
        st = out.pop(k)
        out[f"{k}.coords"], out[f"{k}.num"] = st.coords, st.num_voxels
    return out


@pytest.fixture(scope="module")
def voxel_batch():
    cfg, pcr, vsz, tids = voxelnet_cfg()
    return det_batch(2, pcr, vsz, tids, seed=4, max_voxels=2048), grid(pcr,
                                                                     vsz)


@pytest.mark.parametrize("kind", ["rank", "keys"])
def test_backbone_chain_and_bev(kind, voxel_batch):
    batch, ishape = voxel_batch
    jbb = jbackbone(dict(type="SpMiddleResNetFHD", num_input_features=5))
    V = batch["coordinates"].shape[1]
    feats = batch["voxels"].mean(axis=2)

    def japply(v, coords, nums, f):
        st = jsp.SparseTensor(structure=jsp.build_structure(
            coords, nums, ishape), features=f)
        return jbb.apply(v, st, train=False)

    try:
        jsp.set_table_kind(kind)
        tsp.set_table_kind(kind)
        jstruct = jsp.build_structure(jnp.asarray(batch["coordinates"]),
                                      jnp.asarray(batch["num_voxels"]),
                                      ishape)
        want = jax.jit(lambda c, m: _jax_chain(
            jsp.build_structure(c, m, ishape), V))(
                jnp.asarray(batch["coordinates"]),
                jnp.asarray(batch["num_voxels"]))
        tstruct = tsp.build_structure(t(batch["coordinates"]),
                                      t(batch["num_voxels"]), ishape)
        tbb = tbackbone(dict(type="SpMiddleResNetFHD",
                             num_input_features=5))
        with torch.no_grad():
            assert "inv2" not in tbb.structures(tstruct)
        got = tbb.structures(tstruct, transposed=True)
        assert isinstance(got["t1"], tsp.coord_ops.RankTable if
                          kind == "rank" else tsp.coord_ops.KeyTable)
        for k, w in want.items():
            if "." in k:
                name, part = k.split(".")
                g = getattr(got[name], {"coords": "coords",
                                        "num": "num_voxels"}[part])
            else:
                g = got[k]
            np.testing.assert_array_equal(n(g), np.asarray(w), err_msg=k)
        assert [got[f"s{i}"].spatial_shape for i in range(2, 6)] == [
            (9, 40, 40), (5, 20, 20), (3, 10, 10), (2, 10, 10)]
        if kind == "keys":  # the rulebooks decide the BEV; once is enough
            return
        args = (jnp.asarray(batch["coordinates"]),
                jnp.asarray(batch["num_voxels"]), jnp.asarray(feats))
        var = random_variables(init_shapes(jbb, jsp.SparseTensor(
            structure=jstruct, features=args[2]), train=False), seed=1)
        jbev = jax.jit(japply)(var, *args)
        load_flax_variables(tbb, _np(var))
        with torch.inference_mode():
            tbev = tbb.eval()(tsp.SparseTensor(tstruct, t(feats)))
        assert tbev.shape == (2, 256, 10, 10)
        assert_close_rel(n(tbev).transpose(0, 2, 3, 1), jbev, REL, "bev")
    finally:
        jsp.set_table_kind("auto")
        tsp.set_table_kind("auto")


@pytest.mark.parametrize("shape", [(41, 1024, 1024), (41, 1504, 1504)])
def test_bev_width_at_published_grids(shape):
    jbb = jbackbone(dict(type="SpMiddleResNetFHD", num_input_features=5))
    coords = jnp.zeros((1, 64, 3), jnp.int32)
    st = jsp.SparseTensor(structure=jsp.build_structure(
        coords, jnp.asarray([8], jnp.int32), shape),
        features=jnp.zeros((1, 64, 5)))
    out = jax.eval_shape(lambda: jbb.init_with_output(
        jax.random.PRNGKey(0), st, train=False)[0])
    assert out.shape[-1] == 384 == SpMiddleResNetFHD.bev_channels(shape)
    assert out.shape[1:3] == (-(-shape[1] // 8), -(-shape[2] // 8))


@pytest.mark.parametrize("which", ["voxelnet", "pointpillars"])
def test_rpn(which):
    cfg = (voxelnet_cfg()[0] if which == "voxelnet"
           else pointpillars_cfg()[0])["neck"]
    cin = 24
    x = np.random.default_rng(5).normal(0, 1, (2, 16, 16, cin)).astype(
        np.float32)
    jm = jneck(dict(cfg))
    var = random_variables(init_shapes(jm, jnp.asarray(x), train=False), 2)
    for train in (False, True):
        out = jm.apply(var, jnp.asarray(x), train=train,
                       mutable=["batch_stats"] if train else False)
        want, stats = (out if train else (out, None))
        tm = tneck(dict(cfg, in_channels=cin))
        load_flax_variables(tm, _np(var))
        tm.train(train)
        got = tm(t(x).permute(0, 3, 1, 2).contiguous())
        assert_close_rel(n(got).transpose(0, 2, 3, 1), want, 1e-5, which)
        if train:
            sd = flax_to_state_dict(tm, {"params": _np(var["params"]),
                                         "batch_stats": _np(
                                             stats["batch_stats"])})
            for k, v in tm.state_dict().items():
                if k.endswith("running_var"):
                    assert_close_rel(v, sd[k], 1e-5, k)


def test_center_head_dcn():
    """CenterHead's DCN head against JAX's (test_torch_port_det_head.py
    ``center_head_case``)."""
    from test_torch_port_det_head import center_head_case

    center_head_case("dcn")
