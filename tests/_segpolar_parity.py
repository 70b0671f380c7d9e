"""Shared body of the SegPolarNet parity tests
(tests/test_torch_port_{cylinder3d,polarnet}.py): one seeded points-only
batch through the JAX package's segmentor and the port's, from the same
random Flax variables, on the CPU: the evaluation forward and ``predict``,
then one train step through both packages' make_train_step. The JAX
segmentor is ``FixedSegPolarNet``: its _v2p branch sorts the re-keyed
structure's rows (reference fault 12 in ROADMAP C: the JAX package's
lookups on that unsorted structure return other voxels' rows).

Tolerances: the forward's logits and ``predict``'s softmax within 1e-4 of
the largest reference entry, its labels equal on at least 99.9% of the
valid points (near-ties); the loss terms and the gradient norm within
1e-4 relative; every gradient within 1e-4 of its largest reference entry
(and 1e-4 in relative L2 norm), with an absolute floor of 1e-8 of the
gradient norm; a tensor whose reference gradient lies below that floor
has an analytically zero gradient (a bias in front of a BN, the PP
model's input BN bias in front of a Linear and a BN: both sides hold fp32
cancellation noise of up to 2e-7 on a gradient norm of 10.9), and the
port's must then stay below 10 times the floor; the JAX gradient is read
from the first Adam moment (mu = (1 - b1) g, the clip inactive); the
updated parameters within 1e-2 * lr
where |g| >= 1e-5 and 2 * lr everywhere (Adam's first step is lr *
sign(g)); the BN running statistics within 1e-4 of their largest entry;
integer outputs (the points' voxel coordinates, the voted voxel labels)
equal."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from lidarseg3d_tpu.apis import train as jtrain
from lidarseg3d_tpu.models.segmentors.seg_polarnet import SegPolarNet
from lidarseg3d_tpu.ops import coords as jco
from lidarseg3d_tpu.ops import dynamic_voxel as jdv
from lidarseg3d_tpu.ops import sparse as jsp
from lidarseg3d_tpu.solver.optim import build_one_cycle_optimizer as jbuild_opt
from lidarseg3d_torch.apis import train as ttrain
from lidarseg3d_torch.convert import (flax_params_to_named, flax_to_state_dict,
                                      load_flax_variables)
from lidarseg3d_torch.models import build_detector as tbuild
from lidarseg3d_torch.solver.optim import build_one_cycle_optimizer as tbuild_opt

from _torch_port_helpers import assert_close_rel, init_shapes, n, random_variables

OPT = dict(type="adam", wd=0.01)
LR = dict(lr_max=1e-3, moms=(0.95, 0.85), div_factor=10.0, pct_start=0.4)
TOTAL, CLIP = 10, 35.0
REL = 1e-4
MIN_AGREE = 0.999
CYLR = [0.0, -np.pi, -4.0, 20.0, np.pi, 2.0]


class FixedSegPolarNet(SegPolarNet):
    """The JAX package's SegPolarNet with reference fault 12 (ROADMAP C)
    repaired as the port repairs it: the _v2p branch's re-keyed (z, phi,
    r) structure gets its rows sorted by its own keys (and the features
    and voxel labels with them), so that its table's ranks are its rows.
    Every other branch is the JAX package's."""

    def __call__(self, example, train: bool = True):
        if not self.backbone["type"].endswith("_v2p"):
            return super().__call__(example, train=train)
        batch = dict(example)
        r = self.reader_mod(example["points"], example["point_valid"],
                            example.get("point_sem_labels"), train=train)
        st = self.backbone_mod(r["sparse_tensor"],
                               train=train)["sparse_features"]
        s = st.structure
        rc = s.coords[..., ::-1]
        _, Y, X = s.spatial_shape[::-1]
        keys = jnp.where(s.valid_mask(),
                         (rc[..., 0] * Y + rc[..., 1]) * X + rc[..., 2],
                         jco.INVALID_KEY)
        order = jnp.argsort(keys, axis=1, stable=True)

        def rows(a):
            idx = order.reshape(order.shape + (1,) * (a.ndim - 2))
            return jnp.take_along_axis(a, idx, axis=1)

        rev = jsp.build_structure(rows(rc), s.num_voxels,
                                  s.spatial_shape[::-1])
        batch["conv_point_features"] = rows(st.features)
        batch["conv_structure"] = rev
        batch["conv_table"] = jsp.dense_table(rev)
        batch["points"] = jdv.cart2cylind(example["points"][..., :3])
        if "voxel_sem_labels" in r:
            batch["voxel_sem_labels"] = rows(r["voxel_sem_labels"])
            batch["voxel_valid"] = rev.valid_mask()
        batch["point_vcoors"] = r["point_vcoors"]
        return self.point_head_mod(batch, train=train), batch


def jbuild(cfg):
    """The JAX reference model of a SegPolarNet config (reference fault 12
    repaired, FixedSegPolarNet)."""
    cfg = dict(cfg)
    assert cfg.pop("type") == "SegPolarNet"
    return FixedSegPolarNet(**cfg)


def make_batch(B, N, ncls, seed, fill=False):
    """Seeded points (x, y, z, intensity, time) inside the cylinder's
    range, some padding rows, labels (0 is ignored). ``fill``: uniform in
    (r, phi) instead of in (x, y), so that a small BEV grid has few empty
    cells: a region of empty cells holds equal activations, and a max pool
    over them routes its gradient to whichever equal entry each package's
    rounding makes the largest (both valid subgradients)."""
    rng = np.random.default_rng(seed)
    if fill:
        r = rng.uniform(0.3, 19.7, (B, N))
        phi = rng.uniform(-np.pi, np.pi, (B, N))
        xy = [r * np.cos(phi), r * np.sin(phi)]
    else:
        xy = [rng.uniform(-14, 14, (B, N)), rng.uniform(-14, 14, (B, N))]
    pts = np.stack(xy + [
        rng.uniform(-3.5, 1.5, (B, N)), rng.uniform(0, 1, (B, N)),
        rng.uniform(0, 1, (B, N))], -1).astype(np.float32)
    valid = np.ones((B, N), bool)
    valid[:, -40:] = False
    labels = rng.integers(0, ncls, (B, N)).astype(np.int32)
    return {"points": pts, "point_valid": valid, "point_sem_labels": labels}


def _grad_reference(jm, tx, state, jex):
    """The gradient of the JAX package's training loss as one jax.grad
    program (the batch and BN statistics closed over), the optimizer's
    update applied to it -> (new params, gradient, its global norm)."""

    def loss(params):
        (ret, bat), _ = jm.apply(
            {"params": params, "batch_stats": state.batch_stats}, jex,
            train=True, mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(0)})
        return jm.loss(ret, bat)[0]

    g = jax.jit(jax.grad(loss))(state.params)
    updates, _ = tx.update(g, state.opt_state, state.params)
    return optax.apply_updates(state.params, updates), g, optax.global_norm(g)


def run(cfg, batch, out_keys, jax_step="train_step"):
    """Both packages on ``batch`` -> dict of what the checks read. The
    JAX side's step is its make_train_step (the gradient read from the
    first Adam moment); with ``jax_step="grad"`` its loss terms and BN
    statistics still are, but the gradient, its norm and the updated
    parameters come from ``_grad_reference``."""
    jm = jbuild(copy.deepcopy(cfg))
    jex = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = random_variables(init_shapes(jm, jex, train=False), seed=6)
    jret, jbat, jpred = jax.jit(lambda v, e: (
        lambda rb: rb + (jm.predict(*rb),))(jm.apply(v, e, train=False)))(
        variables, jex)
    tx, jlr = jbuild_opt(OPT, LR, TOTAL, grad_clip=CLIP)
    state = jtrain.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]))
    new_state, jl = jax.jit(jtrain.make_train_step(jm, tx, None))(state, jex)
    b1 = float(new_state.opt_state.hyperparams["b1"])
    jg = jax.tree_util.tree_map(lambda m: np.asarray(m) / (1.0 - b1),
                                new_state.opt_state.inner_state[1].mu)
    if jax_step == "grad":
        params, jg, jl["grad_norm"] = _grad_reference(jm, tx, state, jex)
        new_state = new_state.replace(params=params)

    tm = tbuild(copy.deepcopy(cfg), device="cpu")
    load_flax_variables(tm, jax.tree_util.tree_map(np.asarray, variables))
    ex = ttrain.example_to_device(batch, "cpu")
    tret, tbat = tm(dict(ex, input_shape=None))
    tpred = tm.predict(tret, tbat)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    opt, tlr = tbuild_opt(OPT, LR, TOTAL, grad_clip=CLIP)
    tstate = ttrain.create_train_state(tm, opt)
    step = ttrain.make_train_step(tm, opt, None)
    tstate, tl = step(tstate, ttrain.example_to_device(batch, "cpu"))

    jl = {k: float(v) for k, v in jl.items()}
    named = lambda g: flax_params_to_named(  # noqa: E731
        tm, jax.tree_util.tree_map(np.asarray, g))
    jgrads = named(jg)
    return dict(batch=batch, jret=jret, jbat=jbat, jpred=jpred, tret=tret,
                tbat=tbat, tpred=tpred, jl=jl,
                tl={k: float(v) for k, v in tl.items()}, jgrads=jgrads,
                tm=tm, before=before, tstate=tstate, new_state=new_state,
                lr0=tlr(0), jlr0=float(jlr(0)), out_keys=out_keys)


def check_forward(r):
    for k in r["out_keys"]:
        assert r["tret"][k].shape == np.asarray(r["jret"][k]).shape, k
        assert_close_rel(r["tret"][k], r["jret"][k], REL, k)
    np.testing.assert_array_equal(n(r["tbat"]["point_vcoors"]),
                                  n(r["jbat"]["point_vcoors"]))
    valid = r["batch"]["point_valid"]
    assert_close_rel(n(r["tpred"]["point_softmax"])[valid],
                     np.asarray(r["jpred"]["point_softmax"])[valid], REL,
                     "point_softmax")
    got = n(r["tpred"]["pred_point_sem_labels"])[valid]
    want = np.asarray(r["jpred"]["pred_point_sem_labels"])[valid]
    assert (got == want).mean() >= MIN_AGREE


def check_losses(r, names):
    assert r["jl"]["grad_norm"] < CLIP
    assert set(r["tl"]) == set(r["jl"]) == set(names) | {"loss", "grad_norm"}
    for k, want in r["jl"].items():
        assert np.isfinite(r["tl"][k]), k
        assert abs(r["tl"][k] - want) <= REL * abs(want), (k, r["tl"][k],
                                                          want)


def check_gradients(r):
    named = dict(r["tm"].named_parameters())
    assert set(named) == set(r["jgrads"])
    atol = 1e-8 * r["jl"]["grad_norm"]
    for k, want in r["jgrads"].items():
        got = named[k].grad
        assert got is not None and torch.isfinite(got).all(), k
        scale = float(want.abs().max())
        if scale <= atol:  # analytically zero: noise on both sides
            assert float(got.abs().max()) <= 10 * atol, (k, scale)
            continue
        err = float((got - want).abs().max())
        assert err <= REL * scale + atol, (k, err, scale)
        if scale > 10 * atol:
            l2 = float((got - want).norm() / want.norm())
            assert l2 <= REL, (k, l2)


def check_update(r, min_stats):
    new = flax_params_to_named(r["tm"], jax.tree_util.tree_map(
        np.asarray, r["new_state"].params))
    lr = r["lr0"]
    assert abs(lr - r["jlr0"]) <= 1e-6 * lr
    named = dict(r["tm"].named_parameters())
    for k, want in new.items():
        got = named[k].detach()
        d = (got - want).abs()
        assert float(d.max()) <= 2.0 * lr + 1e-7, (k, float(d.max()))
        firm = r["jgrads"][k].abs() >= 1e-5
        if firm.any():
            assert float(d[firm].max()) <= 1e-2 * lr, (k, float(d[firm].max()))
        assert not torch.equal(got, r["before"][k]), f"{k} did not move"
    want = flax_to_state_dict(r["tm"], {
        "params": jax.tree_util.tree_map(np.asarray, r["new_state"].params),
        "batch_stats": jax.tree_util.tree_map(
            np.asarray, r["new_state"].batch_stats)})
    sd = r["tm"].state_dict()
    stats = [k for k in sd if k.endswith(("running_mean", "running_var"))]
    assert len(stats) >= min_stats
    for k in stats:
        assert_close_rel(sd[k], want[k], REL, k)
    assert r["tstate"].step == 1 and int(r["new_state"].step) == 1
