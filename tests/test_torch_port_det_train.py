"""One CenterPoint VoxelNet train step of the port against the JAX
package's, and on two gloo ranks against one process:

- ``apis.train.make_train_step`` of the mini Waymo VoxelNet
  (configs/tests/mini_waymo_voxelnet.py, velocity head added so the
  10-dim targets' columns all count) at B=2 against JAX's
  ``make_train_step`` (jit) from the same Flax variables, with the
  published optimizer (Adam, decoupled decay 0.01, clip 35, one-cycle):
  the loss terms within 1e-4, every gradient within 1e-4 of its max (and
  in relative L2), the updated parameters within Adam's first step, the
  BN statistics within 1e-4;
- the same step on two gloo ranks with one row each equals one process
  on both rows in float64 within 1e-9: the focal loss's positive count,
  the regression's mask count and every BN are the global batch's.

The JAX package's own DEVICE_BATCH_KEYS carries no det_targets, so its
tools cannot train a detector (ROADMAP §C); its make_train_step gets them
here as the port's example_to_device passes them."""

import copy

import numpy as np
import pytest
import torch

from lidarseg3d_torch.apis import train as ttrain
from lidarseg3d_torch.convert import (flax_params_to_named,
                                      flax_to_state_dict, load_flax_variables)
from lidarseg3d_torch.datasets.batching import collate_segnet
from lidarseg3d_torch.models import build_detector as tbuild
from lidarseg3d_torch.solver.optim import build_one_cycle_optimizer as tbopt

from test_torch_port_det_support import (det_batch, det_step_rank,
                                         device_batch, grid, voxelnet_cfg)
from _torch_ddp import run_ranks
from test_torch_port_support import one_torch_thread  # noqa: F401

OPT = dict(type="adam", amsgrad=0.0, wd=0.01, fixed_wd=True,
           moving_average=False)
LR = dict(lr_max=3e-3, moms=(0.95, 0.85), div_factor=10.0, pct_start=0.4)
TOTAL, CLIP = 10, 35.0
REL = 1e-4
REL64 = 1e-9


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from lidarseg3d_tpu.apis import train as jtrain
    from lidarseg3d_tpu.models import build_detector as jbuild
    from lidarseg3d_tpu.solver.optim import build_one_cycle_optimizer as jbo

    from _torch_port_helpers import init_shapes, random_variables

    cfg, pcr, vsz, tids = voxelnet_cfg(vel=True)
    frames = det_batch(2, pcr, vsz, tids, seed=11, vel=True, nboxes=7,
                       frames=True)
    batch = collate_segnet(frames, 2048, 2048)
    rows = [collate_segnet([f], 2048, 2048) for f in frames]
    ishape = grid(pcr, vsz)
    jm = jbuild(copy.deepcopy(cfg))
    jex = {k: jnp.asarray(batch[k]) for k in jtrain.DEVICE_BATCH_KEYS
           if k in batch}
    jex["det_targets"] = [{k: jnp.asarray(v) for k, v in g.items()}
                          for g in batch["det_targets"]]
    variables = random_variables(
        init_shapes(jm, dict(jex, input_shape=ishape), train=False), seed=12)
    tx, jlr = jbo(OPT, LR, TOTAL, grad_clip=CLIP)
    state = jtrain.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]))
    new_state, jl = jax.jit(jtrain.make_train_step(jm, tx, ishape))(state,
                                                                    jex)
    jl = {k: float(v) for k, v in jl.items()}
    # Adam's first moment after one step is (1 - b1) times the clipped
    # gradient: the gradient scaled by min(1, CLIP / norm)
    unclip = max(1.0, jl["grad_norm"] / CLIP)
    b1 = float(new_state.opt_state.hyperparams["b1"])
    mu = new_state.opt_state.inner_state[1].mu
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731

    tcfg = dict(copy.deepcopy(cfg), input_shape=ishape)
    tm = tbuild(tcfg, device="cpu")
    load_flax_variables(tm, np_tree(variables))
    first = {k: v.clone() for k, v in tm.state_dict().items()}
    opt, tlr = tbopt(OPT, LR, TOTAL, grad_clip=CLIP)
    tstate = ttrain.create_train_state(tm, opt)
    ex = device_batch(batch, torch.float32)
    _, tl = ttrain.make_train_step(tm, opt, ishape)(tstate, ex)

    job = dict(cfg=tcfg, state=first, grid=ishape, dtype=torch.float64,
               optimizer=(OPT, LR, TOTAL), clip=CLIP, batches=[batch])
    one = det_step_rank(0, 1, job)
    ranks = run_ranks(det_step_rank, 2, tmp_path_factory.mktemp("ranks"),
                      dict(job, batches=rows))
    return dict(
        jl=jl, tl={k: float(v) for k, v in tl.items()}, tm=tm, first=first,
        jgrads=flax_params_to_named(tm, jax.tree_util.tree_map(
            lambda m: np.asarray(m) * unclip / (1.0 - b1), mu)),
        jnew=flax_params_to_named(tm, np_tree(new_state.params)),
        jstate=flax_to_state_dict(tm, {
            "params": np_tree(new_state.params),
            "batch_stats": np_tree(new_state.batch_stats)}),
        lr=tlr(0), jlr=float(jlr(0)), one=one, ranks=ranks)


def test_loss_terms_match_jax(run):
    assert set(run["tl"]) == set(run["jl"]) == {
        "loss", "grad_norm", "task0_hm_loss", "task0_loc_loss"}
    for k, want in run["jl"].items():
        assert abs(run["tl"][k] - want) <= REL * abs(want), (
            k, run["tl"][k], want)


def test_every_gradient_matches_jax(run):
    named = dict(run["tm"].named_parameters())
    assert set(named) == set(run["jgrads"])
    atol = 1e-8 * run["jl"]["grad_norm"]
    for k, want in run["jgrads"].items():
        got = named[k].grad
        assert got is not None and torch.isfinite(got).all(), k
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        assert err <= REL * scale + atol, (k, err, scale)
        if scale > 10 * atol:
            l2 = float((got - want).norm() / want.norm())
            assert l2 <= REL, (k, l2)


def test_parameters_and_bn_statistics_match_jax(run):
    lr = run["lr"]
    assert abs(lr - run["jlr"]) <= 1e-6 * lr
    named = dict(run["tm"].named_parameters())
    for k, want in run["jnew"].items():
        d = (named[k].detach() - want).abs()
        assert float(d.max()) <= 2.0 * lr + 1e-7, (k, float(d.max()))
        firm = run["jgrads"][k].abs() >= 1e-5
        if firm.any():
            assert float(d[firm].max()) <= 1e-2 * lr, k
    sd = run["tm"].state_dict()
    stats = [k for k in sd if k.endswith(("running_mean", "running_var"))]
    assert len(stats) > 40
    for k in stats:
        scale = max(float(run["jstate"][k].abs().max()), 1e-6)
        assert float((sd[k] - run["jstate"][k]).abs().max()) <= REL * scale, k


def test_two_ranks_equal_one_process_float64(run):
    one, ranks = run["one"], run["ranks"]
    for got in ranks:
        for k, v in one["losses"].items():
            assert abs(got["losses"][k] - v) <= REL64 * abs(v), k
        assert set(got["grads"]) == set(one["grads"])
        for k, want in one["grads"].items():
            scale = max(float(want.abs().max()), 1e-30)
            err = float((got["grads"][k] - want).abs().max())
            assert err <= REL64 * scale + 1e-14, (k, err, scale)
        for k, want in one["state"].items():
            if want.is_floating_point():
                scale = max(float(want.abs().max()), 1e-30)
                err = float((got["state"][k] - want).abs().max())
                assert err <= REL64 * scale + 1e-14, (k, err)
    for k, v in ranks[0]["state"].items():
        assert torch.equal(v, ranks[1]["state"][k]), k
