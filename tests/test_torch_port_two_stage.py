"""TwoStageDetector of the port against the JAX package's on the mini
Waymo VoxelNet (configs/tests/mini_waymo_voxelnet.py) as its first stage,
the 5-point BEV extractor and a narrow RoI head (DP_RATIO=0), at B=2 with
seeded spread Flax variables (so no two proposals tie), with ``freeze``
False and True. One JAX ``value_and_grad`` of the training forward and
loss per case (jit), against the port's forward, loss and
``make_train_step``:

- the proposals: the selection (labels and valid flags) exact, the RoI
  boxes (decoded from the first stage's fp32 maps) and scores, the RoI
  head's outputs and the predicted boxes and scores within 1e-4 of
  max|JAX|;
- the loss terms within 1e-5 (the first stage's only without freeze);
- the gradients of the RoI head within 1e-4 of their max; under freeze
  every first-stage gradient is exactly 0 (JAX's stop_gradient, the
  port's zero gradients through ``frozen_parameters``), the first stage's
  BN statistics are bit-identical before and after the step and its
  backbone built no inverse rulebook; without freeze the first stage's
  gradients within 1e-4 of their max.

Also the Flax tree of the two-stage model converts into the port's
state_dict and back leaf for leaf (convert.py). The evaluation forward is
held through both tools against JAX's run_det_eval
(test_torch_port_two_stage_entry.py)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidarseg3d_tpu.models import build_detector as jbuild
from lidarseg3d_torch.apis import train as ttrain
from lidarseg3d_torch.convert import (flax_params_to_named, load_flax_variables,
                                      state_dict_to_flax)
from lidarseg3d_torch.models import build_detector as tbuild
from lidarseg3d_torch.solver.optim import build_one_cycle_optimizer

from test_torch_port_det_support import (det_batch, device_batch, grid,
                                         voxelnet_cfg)
from test_torch_port_support import one_torch_thread  # noqa: F401
from _torch_port_helpers import (assert_close_rel, init_shapes, n,
                                 random_variables)

REL = 1e-4
MAXSIZE = 40


def two_stage_cfg(freeze):
    first, pcr, vsz, tids = voxelnet_cfg()
    cfg = dict(
        type="TwoStageDetector", first_stage_cfg=first,
        second_stage_modules=(dict(type="BEVFeatureExtractor",
                                   pc_start=pcr[:2], voxel_size=vsz[:2],
                                   out_stride=8),),
        roi_head=dict(type="RoIHead", input_channels=128 * 5, num_class=1,
                      code_size=7, model_cfg=dict(
                          SHARED_FC=(32, 32), CLS_FC=(16, 16),
                          REG_FC=(16, 16), DP_RATIO=0.0)),
        NMS_POST_MAXSIZE=MAXSIZE, num_point=5, freeze=freeze,
        train_cfg=first.pop("train_cfg"), test_cfg=first.pop("test_cfg"))
    return cfg, pcr, vsz, tids


@pytest.fixture(scope="module", params=[False, True],
                ids=["trained", "frozen"])
def run(request):
    freeze = request.param
    cfg, pcr, vsz, tids = two_stage_cfg(freeze)
    ishape = grid(pcr, vsz)
    batch = det_batch(2, pcr, vsz, tids, seed=31, gt=True, nboxes=8)
    jm = jbuild(copy.deepcopy(cfg))
    jex = {k: jnp.asarray(v) for k, v in batch.items()
           if k not in ("metadata", "det_targets")}
    jex["det_targets"] = [{k: jnp.asarray(v) for k, v in g.items()}
                          for g in batch["det_targets"]]
    var = jax.tree_util.tree_map(np.asarray, random_variables(init_shapes(
        jm, dict(jex, input_shape=ishape), train=False), seed=32))

    def loss(params, ex):
        (r, b), st = jm.apply(
            {"params": params, "batch_stats": var["batch_stats"]},
            dict(ex, input_shape=ishape), train=True,
            mutable=["batch_stats"])
        total, ld = jm.loss(r, b)
        keep = {k: r[k] for k in ("rois", "roi_scores", "roi_labels",
                                  "roi_valid", "rcnn_cls", "rcnn_reg")}
        return total, (ld, st, keep, jm.predict(r, b))

    (_, (jld, jst, jr, jp)), jg = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(var["params"], jex)

    tcfg = copy.deepcopy(cfg)
    tcfg["first_stage_cfg"]["input_shape"] = ishape
    tm = tbuild(tcfg, device="cpu")
    load_flax_variables(tm, var)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    ex = device_batch(batch, torch.float32)
    ex["input_shape"] = ishape
    tm.train()
    tr, tb = tm(ex, generator=torch.Generator().manual_seed(0))
    tp = tm.predict(tr, tb)
    _, tld = tm.loss(tr, tb)
    opt, _ = build_one_cycle_optimizer(
        dict(type="adam", wd=0.01, fixed_wd=True),
        dict(lr_max=3e-4, moms=(0.95, 0.85), div_factor=10.0,
             pct_start=0.4), 10, grad_clip=35.0)
    state = ttrain.create_train_state(tm, opt)
    from lidarseg3d_torch.ops import sparse as sp

    built = []
    orig = sp.inverse_spec
    sp.inverse_spec = lambda *a, **k: built.append(1) or orig(*a, **k)
    try:
        ttrain.make_train_step(tm, opt, ishape)(state, ex)
    finally:
        sp.inverse_spec = orig
    return dict(freeze=freeze, jld={k: float(v) for k, v in jld.items()},
                jr=jax.tree_util.tree_map(np.asarray, jr),
                jp=jax.tree_util.tree_map(np.asarray, jp),
                jst=jax.tree_util.tree_map(np.asarray, jst), var=var,
                jg=flax_params_to_named(tm, jax.tree_util.tree_map(
                    np.asarray, jg)),
                tr=tr, tp=tp,
                tld={k: float(v.detach()) for k, v in tld.items()},
                tm=tm, before=before, inverse_built=len(built))


def test_proposals_and_outputs_match_jax(run):
    tr, jr = run["tr"], run["jr"]
    for k in ("roi_labels", "roi_valid"):
        np.testing.assert_array_equal(n(tr[k]), jr[k], k)
    valid = jr["roi_valid"]
    assert valid.shape == (2, MAXSIZE) and 0 < valid.sum()
    for k in ("rois", "roi_scores", "rcnn_cls", "rcnn_reg"):
        assert_close_rel(tr[k], jr[k], REL, k)
    for k in ("label_preds", "valid"):
        np.testing.assert_array_equal(n(run["tp"][k]), run["jp"][k], k)
    for k in ("box3d_lidar", "scores"):
        assert_close_rel(run["tp"][k], run["jp"][k], REL, k)


def test_loss_terms_match_jax(run):
    want = {"rcnn_loss_cls", "rcnn_loss_reg", "loss"}
    if not run["freeze"]:
        want |= {"task0_hm_loss", "task0_loc_loss"}
    assert set(run["tld"]) == set(run["jld"]) == want
    for k, v in run["jld"].items():
        assert abs(run["tld"][k] - v) <= 1e-5 * abs(v), (k, run["tld"][k], v)


def test_gradients_match_jax(run):
    tm, jg = run["tm"], run["jg"]
    # a floor for the tensors whose gradient cancels (an L1 term's bias):
    # 1e-8 of the global norm, as test_torch_port_det_train.py
    atol = 1e-8 * float(sum(float((g.double() ** 2).sum())
                            for g in jg.values()) ** 0.5)
    for k, p in tm.named_parameters():
        want = jg[k]
        assert p.grad is not None and torch.isfinite(p.grad).all(), k
        if run["freeze"] and k.startswith("single_det."):
            assert not want.any() and not p.grad.any(), k
            continue
        scale = float(want.abs().max())
        err = float((p.grad - want).abs().max())
        assert err <= REL * scale + atol, (k, err, scale)
    assert any(float(p.grad.abs().max()) > 0 for k, p in
               tm.named_parameters() if k.startswith("roi_head_mod."))


def test_frozen_first_stage_keeps_its_statistics(run):
    """Under freeze the first stage's BN statistics are bit-identical after
    the step (and in JAX's mutated collection); without freeze they
    moved. A frozen backbone builds no inverse rulebook."""
    tm, before = run["tm"], run["before"]
    stats = [k for k in before if k.startswith("single_det.")
             and k.endswith(("running_mean", "running_var"))]
    assert stats
    after = tm.state_dict()
    moved = [k for k in stats if not torch.equal(after[k], before[k])]
    jmoved = [k for k in jax.tree_util.tree_leaves_with_path(
        run["jst"]["batch_stats"]["single_det"])
        if not np.array_equal(k[1], _leaf(run["var"]["batch_stats"], k[0]))]
    if run["freeze"]:
        assert not moved and not jmoved
        assert run["inverse_built"] == 0
        assert set(tm.frozen_parameters()) == {
            k for k, _ in tm.named_parameters() if k.startswith("single_det.")}
    else:
        assert len(moved) == len(stats) and jmoved
        assert run["inverse_built"] > 0


def _leaf(tree, path):
    node = tree["single_det"]
    for p in path:
        node = node[p.key]
    return node


def test_state_dict_converts_both_ways():
    """The Flax tree (single_det, roi_head_mod with its TorchLinear_k /
    MaskedBatchNorm_k in call order) converts into the port's state_dict
    and back leaf for leaf."""
    cfg, pcr, vsz, tids = two_stage_cfg(True)
    ishape = grid(pcr, vsz)
    batch = det_batch(1, pcr, vsz, tids, seed=33, gt=True)
    jex = {k: jnp.asarray(batch[k]) for k in ("voxels", "coordinates",
                                              "num_points", "num_voxels")}
    var = jax.tree_util.tree_map(np.asarray, random_variables(init_shapes(
        jbuild(copy.deepcopy(cfg)), dict(jex, input_shape=ishape),
        train=False), seed=34))
    cfg["first_stage_cfg"]["input_shape"] = ishape
    tm = tbuild(cfg, device="cpu")
    load_flax_variables(tm, var)
    back = state_dict_to_flax(tm)
    want = jax.tree_util.tree_leaves_with_path(var)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert set(var["params"]) == {"single_det", "roi_head_mod"}
    assert len(want) == len(got)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], leaf, str(path))
