"""The port's CenterPoint head against the JAX package's,
with the same seeded numpy inputs and Flax variables (convert.py):

- CenterHead (``center_head_case``; its vel case runs in
  test_torch_port_det_detector.py, its DCN case in
  test_torch_port_det_model.py, so that no file holds all three JAX
  compiles): forward, get_loss (with and without velocity; a 10-dim
  target against a vel-less head), decode (rotated NMS, velocity under
  double flip, and all-equal scores, whose order is the lowest index
  first) and the DCN head within 1e-4, labels and valid flags exact;

The JAX side runs under jax.jit."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from lidarseg3d_tpu.models.bbox_heads.center_head import CenterHead as JHead
from lidarseg3d_torch.convert import load_flax_variables
from lidarseg3d_torch.models import build_head as thead
from lidarseg3d_torch.models.bbox_heads.center_head import CenterHead

from test_torch_port_support import one_torch_thread  # noqa: F401
from _torch_port_helpers import (assert_close_rel, init_shapes, n,
                                 random_variables, t)

REL = 1e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _head_inputs(vel, seed=6, B=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, 12, 12, 16)).astype(np.float32)
    tids = [[0], [1, 2]]
    tg = []
    from lidarseg3d_torch.core.center_targets import assign_center_targets
    for _ in range(B):
        d = 9 if vel else 7
        bx = np.concatenate([rng.uniform(-5, 5, (5, 3)),
                             rng.uniform(0.5, 3, (5, 3)),
                             rng.uniform(-3, 3, (5, d - 6))], 1)
        tg.append(assign_center_targets(
            bx.astype(np.float32), rng.integers(0, 3, 5), tids, (12, 12),
            [0.1, 0.1, 1.0], [-6.0, -6.0, -2.0], out_factor=8, max_objs=8,
            min_overlap=0.1))
    tgt = [{k: np.stack([f[i][k] for f in tg]) for k in tg[0][i]}
           for i in range(2)]
    return x, tgt


HEAD = dict(type="CenterHead", in_channels=16,
            tasks=(dict(num_class=1), dict(num_class=2)), weight=0.25,
            share_conv_channel=16)
VEL_HEADS = {"reg": (2, 2), "height": (1, 2), "dim": (3, 2), "rot": (2, 2),
             "vel": (2, 2)}


def _same_decode(want, got):
    for w, g in zip(want, got):
        assert set(w) == set(g)
        for k in ("labels", "valid"):
            np.testing.assert_array_equal(n(g[k]), np.asarray(w[k]), k)
        for k in set(w) - {"labels", "valid"}:
            np.testing.assert_allclose(n(g[k]), np.asarray(w[k]), atol=1e-4,
                                       err_msg=k)


def center_head_case(variant):
    """plain: a vel-less head on 10-dim targets (their vel columns
    dropped), decoded with rotated NMS, then all-equal heatmap scores (the
    hm conv's kernel zeroed: each class scores its bias everywhere)
    decoded in index order; vel: the velocity head, decoded under double
    flip; dcn: the DCN head's maps and loss."""
    from lidarseg3d_tpu.utils.registry import build_from_cfg
    from lidarseg3d_tpu.models.registry import HEADS

    cfg = dict(HEAD)
    if variant == "vel":
        cfg.update(common_heads=VEL_HEADS, code_weights=(1.0,) * 6
                   + (0.2, 0.2, 1.0, 1.0))
    if variant == "dcn":
        cfg["dcn_head"] = True
    x, tgt = _head_inputs(vel=variant != "dcn")
    jm = build_from_cfg(dict(cfg), HEADS)
    var = random_variables(init_shapes(jm, jnp.asarray(x), train=False), 3)
    if variant == "dcn":  # offsets of a few cells: bilinear weights matter
        var = jax.tree_util.tree_map_with_path(
            lambda p, v: v * 40.0 if "FeatureAdaption" in str(p)
            and "Conv_0" in str(p) else v, var)
    tm = thead(dict(cfg))
    load_flax_variables(tm, _np(var))
    tx = t(x).permute(0, 3, 1, 2).contiguous()
    jr, _ = jm.apply(var, jnp.asarray(x), train=True,
                     mutable=["batch_stats"])
    tm.train()
    tr = tm(tx)
    for a, b in zip(jr, tr):
        for k in a:
            assert_close_rel(n(b[k]).transpose(0, 2, 3, 1), a[k], REL, k)
    jtot, jld = jm.get_loss(jr, [{k: jnp.asarray(v) for k, v in g.items()}
                                 for g in tgt])
    ttot, tld = tm.get_loss(tr, [{k: t(v) for k, v in g.items()}
                                 for g in tgt])
    for k in jld:
        assert_close_rel(tld[k], jld[k], REL, k)
    assert_close_rel(ttot, jtot, REL, "loss")

    def eval_maps(v):
        load_flax_variables(tm, _np(v))  # the running statistics before
        with torch.inference_mode():
            return jm.apply(v, jnp.asarray(x), train=False), tm.eval()(tx)

    if variant == "dcn":  # the decode reads the maps only: plain and vel
        return
    jr, tr = eval_maps(var)
    kw = dict(voxel_size=(0.1, 0.1), pc_range=(-6.0, -6.0),
              score_threshold=0.0, nms_iou=0.2, max_out=20)
    # circle NMS: test_torch_port_det_ops.py and the nuScenes circle
    # config's tools against JAX's run_det_eval (test_torch_port_det_entry)
    kws = [dict(kw, double_flip=True) if variant == "vel" else kw]
    decoders = [jax.jit(lambda r, kw=kw: JHead.decode(r, **kw)) for kw in kws]
    for kw, dec in zip(kws, decoders):
        _same_decode(dec(jr), CenterHead.decode(tr, **kw))
    if variant == "plain":
        var = jax.tree_util.tree_map_with_path(
            lambda p, v: jnp.zeros_like(v) if "'Conv_9'" in str(p)
            and "'kernel'" in str(p) else v, var)
        jr, tr = eval_maps(var)
        want = decoders[0](jr)
        assert float(jnp.ptp(jax.nn.sigmoid(jr[0]["hm"]))) == 0.0
        _same_decode(want, CenterHead.decode(tr, **kws[0]))




def test_center_head_plain():
    center_head_case("plain")
