"""The second stage of two-stage CenterPoint against the JAX package's,
with the same seeded numpy inputs and Flax variables (convert.py):

- BEVFeatureExtractor and box_sample_points at num_point 1 and 5, with
  sample points on and beyond the map's edges, within 1e-6 of max|JAX|
  (the port samples its NCHW map, JAX its NHWC one);
- encode_gt_of_rois, generate_predicted_boxes and the RoI head's
  evaluation outputs within 1e-5;
- assign_targets on RoIs jittered from gt boxes (among them a wrong-class
  RoI, an opposite heading and RoIs far from every box): reg_fg exact,
  cls_labels and gt_of_rois within 1e-5;
- get_loss within 1e-5;
- the head's training forward, loss and gradients at DP_RATIO=0 within
  1e-4, its BN statistics within 1e-5;
- the port's dropout on its own (explicit generator, rate, scaling);
- a batch without a valid RoI: finite outputs, BN statistics equal to
  JAX's (MaskedBatchNorm counts max(cnt, 1): they drift toward 0)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidarseg3d_tpu.models.roi_heads import roi_head as jroi
from lidarseg3d_tpu.models.second_stage import bev_extractor as jbev
from lidarseg3d_torch.convert import (flax_params_to_named,
                                      flax_to_state_dict, load_flax_variables)
from lidarseg3d_torch.models.roi_heads import roi_head as troi
from lidarseg3d_torch.models.second_stage import bev_extractor as tbev

from test_torch_port_support import one_torch_thread  # noqa: F401
from _torch_port_helpers import (assert_close_rel, init_shapes, n,
                                 random_variables, t)

HEAD_CFG = dict(SHARED_FC=(32, 32), CLS_FC=(16, 16), REG_FC=(16, 24),
                DP_RATIO=0.0,
                TARGET_CONFIG=dict(REG_FG_THRESH=0.55, CLS_FG_THRESH=0.75,
                                   CLS_BG_THRESH=0.25),
                LOSS_CONFIG=dict(LOSS_WEIGHTS=dict(
                    rcnn_cls_weight=1.0, rcnn_reg_weight=2.0,
                    code_weights=[1.0, 1.0, 1.0, 0.5, 0.5, 0.5, 2.0])))
C_IN = 40


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("num_point", [1, 5])
def test_bev_extractor_matches_jax(num_point):
    rng = np.random.default_rng(num_point)
    B, H, W, C, M = 2, 12, 16, 8, 30
    fmap = rng.normal(size=(B, H, W, C)).astype(np.float32)
    pc_start, vsz, stride = (-4.0, -3.0), (0.25, 0.25), 2  # 0.5 m a pixel
    boxes = np.concatenate([
        rng.uniform([-5.5, -4.5, -1.0], [5.5, 4.5, 1.0], (B, M, 3)),
        rng.uniform(0.5, 3.0, (B, M, 3)),
        rng.uniform(-np.pi, np.pi, (B, M, 1))], -1).astype(np.float32)
    # on the edges: the first pixel, the last pixel (x1 and y1 clamp),
    # and a row beyond both ends
    boxes[0, 0, :2] = pc_start
    boxes[0, 1, :2] = (-4.0 + (W - 1) * 0.5, -3.0 + (H - 1) * 0.5)
    boxes[0, 2, :2] = (-6.0, 5.0)
    boxes[1, 0, :2] = (4.0, -3.0)
    jc = jbev.box_sample_points(jnp.asarray(boxes), num_point)
    jmod = jbev.BEVFeatureExtractor(pc_start=pc_start, voxel_size=vsz,
                                    out_stride=stride)
    want = jmod.apply({}, jnp.asarray(fmap), jc)
    tc = tbev.box_sample_points(t(boxes), num_point)
    assert tc.shape == (B, M * num_point, 3)
    assert_close_rel(tc, jc, 1e-6, "sample points")
    tmod = tbev.BEVFeatureExtractor(pc_start=pc_start, voxel_size=vsz,
                                    out_stride=stride)
    got = tmod(t(fmap).permute(0, 3, 1, 2).contiguous(), tc)
    assert_close_rel(got, want, 1e-6, "features")


def _scene(seed=0, B=2, G=5, N=24):
    """gt boxes [B, G, 8] (a padding row in the second frame), RoIs
    jittered from them (some with the heading turned by pi, one of the
    wrong class, a few far from every box) and their 1-based labels."""
    rng = np.random.default_rng(seed)
    gt = np.zeros((B, G, 8), np.float32)
    gt[..., :3] = rng.uniform([-10, -10, -1], [10, 10, 1], (B, G, 3))
    gt[..., 3:6] = rng.uniform(1.0, 4.0, (B, G, 3))
    gt[..., 6] = rng.uniform(-np.pi, np.pi, (B, G))
    gt[..., 7] = rng.integers(1, 4, (B, G))
    gt[1, -1] = 0.0
    pick = rng.integers(0, G - 1, (B, N))
    rois = np.take_along_axis(gt, pick[..., None], 1)[..., :7].copy()
    rois[..., :3] += rng.uniform(-0.3, 0.3, (B, N, 3))
    rois[..., 3:6] *= rng.uniform(0.85, 1.15, (B, N, 3))
    rois[..., 6] += rng.uniform(-0.2, 0.2, (B, N))
    rois[:, 0:3, 6] += np.pi  # opposite headings
    labels = np.take_along_axis(gt[..., 7], pick, 1).astype(np.int32)
    labels[:, 3] = labels[:, 3] % 3 + 1  # the wrong class
    rois[:, -3:, :2] = rng.uniform(30, 40, (B, 3, 2))  # far from every box
    return gt, rois.astype(np.float32), labels


def test_encode_and_decode_match_jax():
    gt, rois, _ = _scene(1)
    matched = np.roll(gt[..., :7], 1, axis=1)[:, :1].repeat(rois.shape[1],
                                                             1)
    want = jroi.encode_gt_of_rois(jnp.asarray(rois), jnp.asarray(matched))
    got = troi.encode_gt_of_rois(t(rois), t(matched))
    assert_close_rel(got, want, 1e-5, "gt_of_rois")
    reg = np.random.default_rng(2).normal(0, 0.5, rois.shape).astype(
        np.float32)
    want = jroi.RoIHead.generate_predicted_boxes(jnp.asarray(rois),
                                                 jnp.asarray(reg))
    got = troi.RoIHead.generate_predicted_boxes(t(rois), t(reg))
    assert_close_rel(got, want, 1e-5, "boxes")


def test_assign_targets_matches_jax():
    gt, rois, labels = _scene(3)
    args = (gt[..., :7], gt[..., 7].astype(np.int32), gt[..., 3] > 0)
    want = jax.jit(lambda *a: jroi.assign_targets(
        *a, HEAD_CFG["TARGET_CONFIG"]))(jnp.asarray(rois),
                                        jnp.asarray(labels),
                                        *map(jnp.asarray, args))
    got = troi.assign_targets(t(rois), t(labels), *map(t, args),
                              HEAD_CFG["TARGET_CONFIG"])
    fg = n(got["reg_fg"])
    np.testing.assert_array_equal(fg, np.asarray(want["reg_fg"]))
    assert 0 < fg.sum() < fg.size
    assert not fg[:, -3:].any() and not fg[:, 3].any()
    for k in ("cls_labels", "gt_of_rois"):
        np.testing.assert_allclose(n(got[k]), np.asarray(want[k]),
                                   atol=1e-5, err_msg=k)
    # an opposite heading encodes to a small heading residual
    assert np.abs(n(got["gt_of_rois"])[:, 0:3, 6]).max() < 0.25


def _head_inputs(seed, valid_share=0.7, B=2, N=24):
    rng = np.random.default_rng(seed)
    feats = rng.normal(0, 1, (B, N, C_IN)).astype(np.float32)
    valid = rng.uniform(size=(B, N)) < valid_share
    return feats, valid


def _heads(seed, dp=0.0):
    cfg = dict(HEAD_CFG, DP_RATIO=dp)
    jh = jroi.RoIHead(input_channels=C_IN, model_cfg=cfg, num_class=1,
                      code_size=7)
    feats, valid = _head_inputs(seed)
    var = _np(random_variables(init_shapes(
        jh, jnp.asarray(feats), jnp.asarray(valid), train=False), seed))
    th = troi.RoIHead(input_channels=C_IN, model_cfg=cfg, num_class=1,
                      code_size=7)
    load_flax_variables(th, var)
    return jh, th, var


def test_head_outputs_match_jax():
    jh, th, var = _heads(4)
    feats, valid = _head_inputs(5)
    jc, jr = jh.apply(var, jnp.asarray(feats), jnp.asarray(valid),
                      train=False)
    with torch.inference_mode():
        tc, tr = th.eval()(t(feats), t(valid))
    assert_close_rel(tc, jc, 1e-5, "rcnn_cls")
    assert_close_rel(tr, jr, 1e-5, "rcnn_reg")
    names = [k for k in th.state_dict() if k.endswith("weight")
             and "TorchLinear" in k]
    assert names == [f"TorchLinear_{i}.weight" for i in range(8)]


def test_get_loss_matches_jax():
    gt, rois, labels = _scene(6)
    targets = troi.assign_targets(t(rois), t(labels), t(gt[..., :7]),
                                  t(gt[..., 7].astype(np.int32)),
                                  t(gt[..., 3] > 0),
                                  HEAD_CFG["TARGET_CONFIG"])
    rng = np.random.default_rng(7)
    cls = rng.normal(0, 2, rois.shape[:2] + (1,)).astype(np.float32)
    reg = rng.normal(0, 0.3, rois.shape).astype(np.float32)
    valid = rng.uniform(size=rois.shape[:2]) < 0.8
    jt = {k: jnp.asarray(n(v)) for k, v in targets.items()}
    jl, jld = jroi.RoIHead.get_loss(jnp.asarray(cls), jnp.asarray(reg), jt,
                                    jnp.asarray(valid),
                                    HEAD_CFG["LOSS_CONFIG"])
    tl, tld = troi.RoIHead.get_loss(t(cls), t(reg), targets, t(valid),
                                    HEAD_CFG["LOSS_CONFIG"])
    assert float(jld["rcnn_loss_reg"]) > 0
    for k in jld:
        assert_close_rel(tld[k], jld[k], 1e-5, k)
    assert_close_rel(tl, jl, 1e-5, "loss")


def _train_step_both(valid_share, seed):
    """The head's training forward, loss and gradients at DP_RATIO=0 on
    both sides -> (JAX (outputs, losses, grads, batch_stats), port head,
    port outputs, port losses)."""
    jh, th, var = _heads(seed)
    feats, valid = _head_inputs(seed + 1, valid_share)
    gt, rois, labels = _scene(seed + 2, N=feats.shape[1])
    targets = troi.assign_targets(t(rois), t(labels), t(gt[..., :7]),
                                  t(gt[..., 7].astype(np.int32)),
                                  t(gt[..., 3] > 0),
                                  HEAD_CFG["TARGET_CONFIG"])
    jt = {k: jnp.asarray(n(v)) for k, v in targets.items()}

    def loss(params):
        (c, r), st = jh.apply(
            {"params": params, "batch_stats": var["batch_stats"]},
            jnp.asarray(feats), jnp.asarray(valid), train=True,
            mutable=["batch_stats"])
        total, ld = jroi.RoIHead.get_loss(c, r, jt, jnp.asarray(valid),
                                          HEAD_CFG["LOSS_CONFIG"])
        return total, (c, r, ld, st)

    (_, (jc, jr, jld, jst)), jg = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(var["params"])
    th.train()
    tc, tr = th(t(feats), t(valid))
    tl, tld = troi.RoIHead.get_loss(tc, tr, targets, t(valid),
                                    HEAD_CFG["LOSS_CONFIG"])
    tl.backward()
    return (jc, jr, jld, _np(jg), _np(jst), var), th, (tc, tr), tld


def test_head_train_step_matches_jax():
    (jc, jr, jld, jg, jst, var), th, (tc, tr), tld = _train_step_both(
        0.7, 8)
    assert_close_rel(tc, jc, 1e-4, "rcnn_cls")
    assert_close_rel(tr, jr, 1e-4, "rcnn_reg")
    for k in jld:
        assert_close_rel(tld[k], jld[k], 1e-4, k)
    want = flax_params_to_named(th, jg)
    for k, p in th.named_parameters():
        assert p.grad is not None, k
        assert_close_rel(p.grad, want[k], 1e-4, k)
    stats = flax_to_state_dict(th, {"params": var["params"],
                                    "batch_stats": jst["batch_stats"]})
    for k, v in th.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            assert_close_rel(v, stats[k], 1e-5, k)


def test_head_without_valid_roi_matches_jax():
    (jc, jr, _, _, jst, var), th, (tc, tr), tld = _train_step_both(0.0, 9)
    for x in (tc, tr, *tld.values()):
        assert torch.isfinite(x).all()
    assert_close_rel(tc, jc, 1e-4, "rcnn_cls")
    stats = flax_to_state_dict(th, {"params": var["params"],
                                    "batch_stats": jst["batch_stats"]})
    for k, v in th.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(n(v), n(stats[k]), atol=1e-7,
                                       err_msg=k)
    # no valid entry: mean 0 and var 0 enter with momentum 0.1
    key = "MaskedBatchNorm_0.running_var"
    old = flax_to_state_dict(th, var)[key]
    np.testing.assert_allclose(n(th.state_dict()[key]), n(old) * 0.9,
                               rtol=1e-6)


def test_dropout_needs_a_generator_and_scales():
    _, th, _ = _heads(10, dp=0.3)
    feats, valid = _head_inputs(11, B=4, N=200)
    th.train()
    with pytest.raises(ValueError, match="Generator"):
        th(t(feats), t(valid))
    seen = {}
    second = th.shared[1][0]  # the shared Linear after the first dropout
    hook = second.register_forward_pre_hook(
        lambda m, args: seen.setdefault("x", args[0].detach().clone()))
    out1 = th(t(feats), t(valid), generator=torch.Generator().manual_seed(1))
    hook.remove()
    # the first shared layer's activations, recomputed without dropout
    lin, bn = th.shared[0]
    with torch.no_grad():
        th.eval()
        bn.train()
        plain = torch.relu(bn(lin(t(feats)), mask=t(valid)))
        th.train()
    x = seen["x"]
    kept = x != 0
    live = plain != 0
    assert abs(float(kept[live].float().mean()) - 0.7) < 0.02
    assert torch.allclose(x[kept], (plain / 0.7)[kept], rtol=1e-5,
                          atol=1e-6)
    out2 = th(t(feats), t(valid), generator=torch.Generator().manual_seed(1))
    out3 = th(t(feats), t(valid), generator=torch.Generator().manual_seed(2))
    assert torch.equal(out1[0], out2[0]) and torch.equal(out1[1], out2[1])
    assert not torch.equal(out1[1], out3[1])
    th.eval()  # evaluation: the identity, no generator needed
    with torch.inference_mode():
        th(t(feats), t(valid))
    assert math.isclose(th.dp, 0.3)
