"""lidarseg3d_torch PointSegMSeg3DHead in training mode against the JAX
package's head (train=True): outputs, the five get_loss terms and the new
BN statistics, for both OOV_COMPLETION modes, with DP_RATIO=0 on both
sides (the frameworks draw different dropout masks); plus the port's
dropout on its own (explicit generator, rate, scaling).

Tolerance: fp32, max |err| <= 1e-4 * max |reference| (six attention
layers on batch statistics); loss terms 1e-5 relative."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from __graft_entry__ import (_grid_shape, _mseg3d_model_cfg,
                             _synthetic_mseg3d_batch, PCR, VSZ)
from lidarseg3d_tpu.models import build_point_head as jbuild_head
from lidarseg3d_tpu.ops import sparse as jsp
from lidarseg3d_torch.convert import flax_to_state_dict, load_flax_variables
from lidarseg3d_torch.models import build_point_head as tbuild_head
from lidarseg3d_torch.ops import sparse as tsp

from _torch_port_helpers import (assert_close_rel, init_shapes, n,
                                 random_variables, t)

KEYS = ("voxel_logits", "point_features_camera", "point_features_pcamera",
        "out_logits")


def _head_cfg(oov, dp):
    cfg = _mseg3d_model_cfg(ratio=1)["point_head"]
    mc = dict(cfg["model_cfg"], DP_RATIO=dp, OOV_COMPLETION=oov)
    mc["SFPhase_CFG"] = dict(mc["SFPhase_CFG"], n_layer=2)
    return dict(cfg, model_cfg=mc, voxel_size=tuple(VSZ),
                point_cloud_range=tuple(PCR))


@pytest.fixture(scope="module")
def scene():
    b = _synthetic_mseg3d_batch(2, 1024, 1024, img_hw=(64, 128), seed=6,
                                with_labels=True)
    ishape = _grid_shape()
    rng = np.random.default_rng(0)
    arrays = dict(
        conv_point_features=rng.normal(size=(2, 1024, 16)).astype(np.float32),
        image_features=rng.normal(size=(2, 16, 32, 48)).astype(np.float32),
        camera_semantic_embeddings=rng.normal(size=(2, 20, 48)).astype(
            np.float32),
        **{k: b[k] for k in ("point_valid", "points", "points_cuv",
                             "voxel_valid", "voxel_sem_labels",
                             "point_sem_labels")})
    js = jsp.build_structure(jnp.asarray(b["coordinates"]),
                             jnp.asarray(b["num_voxels"]), ishape)
    ts = tsp.build_structure(t(b["coordinates"]), t(b["num_voxels"]), ishape)
    jt, tt = jsp.dense_table(js), tsp.dense_table(ts)
    jbatch = dict({k: jnp.asarray(v) for k, v in arrays.items()},
                  conv_structure=js, conv_table=jt,
                  conv_subm_rulebook=jsp.build_subm_rulebook(js, table=jt))
    tbatch = dict({k: t(v) for k, v in arrays.items()}, conv_structure=ts,
                  conv_table=tt,
                  conv_subm_rulebook=tsp.build_subm_rulebook(ts, table=tt))
    return jbatch, tbatch


@pytest.mark.parametrize("oov", ["pseudo_camera", "zero"])
def test_training_forward_and_losses_match_jax(scene, oov):
    jbatch, tbatch = scene
    cfg = _head_cfg(oov, dp=0)
    jhead = jbuild_head(dict(cfg))
    v = random_variables(init_shapes(jhead, jbatch, train=False), seed=3)

    @jax.jit
    def run(v, bt):
        ret, new = jhead.apply(v, bt, train=True, mutable=["batch_stats"])
        return ret, jhead.get_loss(ret, bt), new["batch_stats"]

    want, (wloss, wdict), wstats = run(v, jbatch)
    thead = tbuild_head(dict(cfg))
    load_flax_variables(thead, v)
    thead.train()
    got = thead(tbatch)
    for k in KEYS:
        assert_close_rel(got[k], want[k], 1e-4, k)
    np.testing.assert_array_equal(n(got["in_view"]), n(want["in_view"]))
    loss, ldict = thead.get_loss(got, tbatch)
    assert set(ldict) == set(wdict)
    for k in wdict:
        np.testing.assert_allclose(float(ldict[k].detach()), float(wdict[k]),
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(loss.detach()), float(wloss), rtol=1e-5)
    new = flax_to_state_dict(thead, {
        "params": v["params"],
        "batch_stats": jax.tree_util.tree_map(np.asarray, wstats)})
    sd = thead.state_dict()
    for k in sd:
        if k.endswith(("running_mean", "running_var")):
            assert_close_rel(sd[k], new[k], 1e-4, k)


def test_oov_modes_differ_only_downstream_of_the_completion(scene):
    _, tbatch = scene
    heads = {}
    for oov in ("pseudo_camera", "zero"):
        h = tbuild_head(dict(_head_cfg(oov, dp=0)))
        if heads:
            h.load_state_dict(heads["pseudo_camera"][0].state_dict())
        h.eval()
        with torch.inference_mode():
            heads[oov] = (h, h(tbatch))
    a, b = heads["pseudo_camera"][1], heads["zero"][1]
    for k in ("voxel_logits", "point_features_camera",
              "point_features_pcamera"):
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["out_logits"], b["out_logits"])
    with pytest.raises(NotImplementedError):
        tbuild_head(dict(_head_cfg("nearest", dp=0)))


def test_dropout_needs_a_generator_and_scales(scene):
    _, tbatch = scene
    h = tbuild_head(dict(_head_cfg("pseudo_camera", dp=0.25)))
    h.train()
    with pytest.raises(ValueError, match="Generator"):
        h(tbatch)
    seen = {}
    lin = h.MLPHead_0.layers[0][0]
    hook = lin.register_forward_pre_hook(
        lambda m, args: seen.setdefault("x", args[0].detach().clone()))
    out1 = h(tbatch, generator=torch.Generator().manual_seed(1))
    hook.remove()
    x, f = seen["x"], tbatch["conv_point_features"]
    kept = x != 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.02
    assert torch.allclose(x[kept], (f / 0.75)[kept])
    out2 = h(tbatch, generator=torch.Generator().manual_seed(1))
    out3 = h(tbatch, generator=torch.Generator().manual_seed(2))
    assert torch.equal(out1["voxel_logits"], out2["voxel_logits"])
    assert not torch.equal(out1["voxel_logits"], out3["voxel_logits"])
    h.eval()  # evaluation: the identity, no generator needed
    with torch.inference_mode():
        h(tbatch)
