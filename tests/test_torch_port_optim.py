"""lidarseg3d_torch.solver.optim against the JAX package's optax chain
(lidarseg3d_tpu/solver/optim.py): 20 steps on a small parameter tree with
given gradients, comparing the learning rate, beta1 and every parameter
after each step, for the OneCycle optimizer (with a gradient that the
clip scales and one it leaves) and the multistep fallback.

Tolerance: schedules within 1e-6 relative plus 1e-7 of their largest value
(float64 here; float32 there, whose cosine cancels near the schedule's end);
parameters within 2e-6 of the largest reference entry per step (fp32, the
same chain with fused multiply-adds in other places)."""

import numpy as np
import jax.numpy as jnp
import optax
import pytest
import torch

from lidarseg3d_tpu.solver import optim as JO
from lidarseg3d_torch.solver import optim as TO

from _torch_port_helpers import assert_close_rel, t

STEPS = 20
SHAPES = {"w": (5, 7), "b": (7,), "scale": (3,)}


def _tree(rng, scale):
    return {k: (rng.normal(size=s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _run(jtx, topt, grad_scale):
    rng = np.random.default_rng(0)
    p0 = _tree(rng, 1.0)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = jtx.init(jp)
    names = sorted(SHAPES)
    tp = [t(p0[k]).clone() for k in names]
    tstate = topt.init(tp)
    for step in range(STEPS):
        g = _tree(rng, grad_scale * (1 + step % 3))
        upd, jstate = jtx.update({k: jnp.asarray(v) for k, v in g.items()},
                                 jstate, jp)
        jp = optax.apply_updates(jp, upd)
        norm = topt.update(tp, [t(g[k]) for k in names], tstate)
        want_norm = optax.global_norm({k: jnp.asarray(v)
                                       for k, v in g.items()})
        assert_close_rel(norm, want_norm, 1e-6, f"grad norm, step {step}")
        for k, p in zip(names, tp):
            assert_close_rel(p, jp[k], 2e-6, f"{k} after step {step}")
    assert tstate.count == STEPS
    return jstate


@pytest.mark.parametrize("grad_scale", [0.1, 30.0],
                         ids=["below_clip", "clipped"])
def test_one_cycle_matches_optax(grad_scale):
    ocfg = dict(type="adam", wd=0.01)
    lcfg = dict(lr_max=3e-3, moms=(0.95, 0.85), div_factor=10.0,
                pct_start=0.4)
    jtx, jlr = JO.build_one_cycle_optimizer(ocfg, lcfg, STEPS, grad_clip=35.0)
    topt, tlr = TO.build_one_cycle_optimizer(ocfg, lcfg, STEPS,
                                             grad_clip=35.0)
    jmom = JO.one_cycle_mom_fn(STEPS, (0.95, 0.85), 0.4)
    for step in range(STEPS + 2):
        np.testing.assert_allclose(tlr(step), float(jlr(step)), rtol=1e-6,
                                   atol=1e-7 * lcfg["lr_max"])
        np.testing.assert_allclose(topt.b1_fn(step), float(jmom(step)),
                                   rtol=1e-6, atol=1e-7)
    jstate = _run(jtx, topt, grad_scale)
    # the hyperparameters optax injected at the last update are those of
    # the count before the increment
    np.testing.assert_allclose(
        float(jstate.hyperparams["learning_rate"]), tlr(STEPS - 1),
        rtol=1e-6, atol=1e-7 * lcfg["lr_max"])


def test_multistep_matches_optax():
    ocfg = dict(lr=2e-3, weight_decay=0.02)
    lcfg = dict(milestones=[5, 12], gamma=0.1)
    jtx, jlr = JO.build_multistep_optimizer(ocfg, lcfg, STEPS, grad_clip=10.0)
    topt, tlr = TO.build_multistep_optimizer(ocfg, lcfg, STEPS,
                                             grad_clip=10.0)
    for step in range(STEPS):
        np.testing.assert_allclose(tlr(step), float(jlr(step)), rtol=1e-6)
    _run(jtx, topt, 1.0)


def test_update_leaves_the_gradients():
    topt, _ = TO.build_one_cycle_optimizer(
        dict(type="adam", wd=0.01), dict(lr_max=1e-3), 10, grad_clip=1.0)
    p = [torch.ones(4)]
    g = [torch.full((4,), 100.0)]
    topt.update(p, g, topt.init(p))
    assert torch.equal(g[0], torch.full((4,), 100.0))
    assert not torch.equal(p[0], torch.ones(4))
