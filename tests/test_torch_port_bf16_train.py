"""The MSeg3D train step with the image branch in bf16 (HRNet and
FCNMSeg3DHead ``compute_dtype="bfloat16"``) through
apis.train.make_train_step, against the JAX package's bf16 step on the
mini config (frozen_stages=3, B=1, V=N=512, one 64x128 camera, DP_RATIO=0,
HRNet's BN on running statistics) from the same random Flax variables and
batch. The JAX step runs in a fresh interpreter
(tests/_torch_port_bf16_jax_step.py): compiling its bf16 convs inside a
long pytest process segfaults (tests/_bf16_test_body.py).

Conditioning: at random weights HRNet's batch-statistics BN makes the
stage-4 gradient chaotic, so bf16 rounding, wherever it falls, decides
it: there the port against JAX reads 0.52 relative L2 over the stage-4
gradients, JAX's own fp32 against its bf16 0.44 (the script below with
``--batch-stats``). So HRNet runs under ``norm_eval`` (its stage-4 convs
still train in bf16); the image head's BN keeps batch statistics.

Exact: the parameters, the optimizer's moments and the BN statistics stay
fp32 and the image branch's activations are bf16; the frozen stages'
gradients are zero and their BN statistics unchanged, on both sides; the
new parameters are Adam's update of the port's own moments; the port's
step with HRNet's ``with_cp`` (each HR module recomputed in the
backward) equals the step without it bit for bit.

Limits, set between the port-against-JAX reading and a control the limit
must fail (readings: ``PYTHONPATH=. python
tests/test_torch_port_bf16_train.py OUT.pkl [--batch-stats]``, which
also prints JAX's fp32 step against its bf16 one):
- the gradients, by group (lidar branch and point head, image head,
  HRNet's stage 4), relative L2 over the group's tensors together: read
  0.0164 / 0.0892 / 0.1596 (JAX fp32 against bf16: 0.0138 / 0.0810 /
  0.1284); limits 0.05 / 0.25 / 0.4. A zeroed group reads 1.0, a reversed
  one 2.0, one of random direction about 1.41;
- Adam's second moment (the squared gradient), by group, the same way:
  read 0.0191 / 0.1048 / 0.1517 (JAX: 0.0173 / 0.0950 / 0.1156); the same
  limits; a zeroed group reads 1.0;
- loss terms: read up to 2.7e-4 relative (image_ce_loss; JAX: 6.5e-4,
  out_mimic_loss); limit 1e-3. grad_norm: read 2.0e-3 (JAX: 2.1e-3);
  limit 1e-2;
- BN running statistics, their distance over the size of their update in
  this step, over every updated tensor of a kind: read 2.4e-3 (means) and
  1.4e-3 (variances) (JAX: 2.6e-3 / 6.4e-4); limit 2e-2; statistics left
  unchanged read 1.0."""

import copy
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from lidarseg3d_torch import synthetic as syn
from lidarseg3d_torch.apis import train as ttrain
from lidarseg3d_torch.convert import (flax_params_to_named,
                                      flax_to_state_dict,
                                      load_flax_variables)
from lidarseg3d_torch.models import build_detector
from lidarseg3d_torch.solver.optim import build_one_cycle_optimizer

import _torch_port_bf16_jax_step as J
from test_torch_port_support import one_torch_thread  # noqa: F401

GROUPS = ("lidar+head", "image head", "image backbone")
REL_LOSS, REL_GRAD_NORM = 1e-3, 1e-2
REL_GRAD = {"lidar+head": 0.05, "image head": 0.25, "image backbone": 0.4}
REL_STATS = {"running_mean": 2e-2, "running_var": 2e-2}


def group(name):
    if name.startswith("img_backbone_mod."):
        return "image backbone"
    return "image head" if name.startswith("img_head_mod.") \
        else "lidar+head"


def by_group(got, want, keys=None):
    """Relative L2 distance of ``got`` from ``want`` over each group's
    tensors together: {group: ||got - want|| / ||want||}."""
    acc = {}
    for k in keys or want:
        d, w = got[k].double() - want[k].double(), want[k].double()
        num, den = acc.get(group(k), (0.0, 0.0))
        acc[group(k)] = (num + float(d.square().sum()),
                         den + float(w.square().sum()))
    return {g: (n / d) ** 0.5 for g, (n, d) in acc.items() if d > 0}


def stats_error(got, want, before):
    """BN running statistics: ||got - want|| / ||want - before|| over all
    the tensors of each kind that this step updated."""
    acc = {}
    for k, w in want.items():
        kind = k.rsplit(".", 1)[-1]
        if kind not in REL_STATS or torch.equal(w, before[k]):
            continue
        num, den = acc.get(kind, (0.0, 0.0))
        acc[kind] = (num + float((got[k] - w).double().square().sum()),
                     den + float((w - before[k]).double().square().sum()))
    return {kind: (n / d) ** 0.5 for kind, (n, d) in acc.items()}


def port_step(variables, with_cp=False, norm_eval=True):
    cfg, mcfg = J.model_cfg(True, norm_eval)
    mcfg["img_backbone"].pop("s2d_max_c")
    mcfg["img_backbone"]["with_cp"] = with_cp
    tm = build_detector(copy.deepcopy(mcfg), device="cpu")
    load_flax_variables(tm, variables)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    opt, _ = build_one_cycle_optimizer(J.OPT, J.LR, J.TOTAL,
                                       grad_clip=J.CLIP)
    state = ttrain.create_train_state(tm, opt)
    pcr, vsz = cfg.point_cloud_range, cfg.voxel_size
    step = ttrain.make_train_step(tm, opt, syn.grid_shape(pcr, vsz))
    batch = syn.synthetic_mseg3d_batch(J.B, J.V, J.N, img_hw=J.IMG, seed=5,
                                       with_labels=True, pcr=pcr, vsz=vsz)
    dtypes = []
    hook = tm.img_backbone_mod.register_forward_hook(
        lambda m, a, out: dtypes.extend(o.dtype for o in out))
    state, losses = step(state, ttrain.example_to_device(batch, "cpu"))
    hook.remove()
    return dict(model=tm, state=state, before=before, opt=opt,
                losses={k: float(v) for k, v in losses.items()},
                dtypes=dtypes)


def jax_step(out, flags=()):
    body = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "_torch_port_bf16_jax_step.py")
    res = subprocess.run([sys.executable, body, out, *flags],
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert res.returncode == 0 and "BF16-STEP-OK" in res.stdout, \
        res.stderr[-3000:]
    with open(out, "rb") as f:
        return pickle.load(f)


def compare(jax_out, side="bf16", norm_eval=True):
    """The port's bf16 step against JAX's ``side`` step: the port's
    results and JAX's in the port's names."""
    r = port_step(jax_out["variables"], norm_eval=norm_eval)
    tm, j = r["model"], jax_out[side]
    r["jax_losses"] = j["losses"]
    r["jgrads"] = flax_params_to_named(tm, j["grads"])
    r["jnu"] = flax_params_to_named(tm, j["nu"])
    r["jnew"] = flax_to_state_dict(tm, {"params": j["params"],
                                        "batch_stats": j["batch_stats"]})
    r["variables"] = jax_out["variables"]
    names = [k for k, _ in tm.named_parameters()]
    r["nu"] = dict(zip(names, r["state"].opt_state.nu))
    r["grads"] = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                  for k, p in tm.named_parameters()}
    return r


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("bf16") / "jax.pkl")
    return compare(jax_step(out))


def test_loss_terms_within_bf16_spread(run):
    assert set(run["losses"]) == set(run["jax_losses"])
    for k, want in run["jax_losses"].items():
        got = run["losses"][k]
        tol = REL_GRAD_NORM if k == "grad_norm" else REL_LOSS
        assert np.isfinite(got) and abs(got - want) <= tol * abs(want), (
            k, got, want)


def test_parameters_stay_fp32_and_the_image_branch_runs_bf16(run):
    assert run["dtypes"] and all(d == torch.bfloat16 for d in run["dtypes"])
    for k, v in run["model"].state_dict().items():
        assert v.dtype in (torch.float32, torch.int64), k
    opt = run["state"].opt_state
    assert all(m.dtype == torch.float32 for m in list(opt.mu) + list(opt.nu))


def test_frozen_stages_get_no_gradient_and_keep_their_statistics(run):
    tm, before = run["model"], run["before"]
    named = dict(tm.named_parameters())
    frozen = set(tm.frozen_parameters())
    assert frozen
    for k in frozen:
        g = named[k].grad
        assert (g is None or not g.any()) and not run["jgrads"][k].any(), k
    hb = tm.img_backbone_mod
    names = {id(m): n for n, m in hb.named_modules()}
    stats = [f"img_backbone_mod.{names[id(m)]}.{b}"
             for part in hb.frozen_parts() for m in part.modules()
             if hasattr(m, "running_mean")
             for b in ("running_mean", "running_var")]
    sd = tm.state_dict()
    for k in stats:
        assert torch.equal(sd[k], before[k]), k
        assert torch.equal(run["jnew"][k], before[k]), k


def test_gradients_within_bf16_spread(run):
    err = by_group(run["grads"], run["jgrads"])
    assert set(err) == set(GROUPS)
    for g, e in err.items():
        assert e <= REL_GRAD[g], (g, e)


def test_statistics_and_parameters_within_bf16_spread(run):
    tm, opt = run["model"], run["opt"]
    sd = tm.state_dict()
    err = stats_error(sd, run["jnew"], run["before"])
    assert set(err) == set(REL_STATS)
    for kind, e in err.items():
        assert e <= REL_STATS[kind], (kind, e)
    nu = by_group(run["nu"], run["jnu"])
    assert set(nu) == set(GROUPS)
    for g, e in nu.items():
        assert e <= REL_GRAD[g], (g, e)
    # the parameters: Adam's first step from the port's own moments
    state = run["state"].opt_state
    lr, b1 = opt.lr_fn(0), opt.b1_fn(0)
    for (k, p), mu, nu in zip(tm.named_parameters(), state.mu, state.nu):
        old = run["before"][k].double()
        upd = (mu.double() / (1 - b1)) / (
            (nu.double() / (1 - opt.b2)).sqrt() + opt.eps)
        want = old - lr * (upd + opt.wd * old)
        assert float((p.detach().double() - want).abs().max()) <= 1e-7, k


def test_remat_step_equals_the_stored_one(run):
    again = port_step(run["variables"], with_cp=True)
    assert again["losses"] == run["losses"]
    a, b = again["model"].state_dict(), run["model"].state_dict()
    for k in b:
        assert torch.equal(a[k], b[k]), k
    ga = dict(again["model"].named_parameters())
    for k, p in run["model"].named_parameters():
        if p.grad is None:
            assert ga[k].grad is None, k
        else:
            assert torch.equal(ga[k].grad, p.grad), k


def readings(out, flags):
    """Print the port's bf16 step against JAX's, JAX's fp32 step against
    its bf16 one, and the controls: the numbers the limits come from."""
    jax_out = jax_step(out, ["--fp32", *flags])
    norm_eval = "--batch-stats" not in flags
    r = compare(jax_out, norm_eval=norm_eval)
    f = compare(jax_out, "fp32", norm_eval)
    jb, jf = r["jax_losses"], f["jax_losses"]
    print("loss terms, relative: port against JAX "
          + ", ".join(f"{k} {abs(r['losses'][k] - v) / abs(v):.2e}"
                      for k, v in jb.items()))
    print("                      JAX fp32 against bf16 "
          + ", ".join(f"{k} {abs(jf[k] - v) / abs(v):.2e}"
                      for k, v in jb.items()))
    print("gradients by group: port against JAX",
          by_group(r["grads"], r["jgrads"]), "; JAX fp32 against bf16",
          by_group(f["jgrads"], r["jgrads"]))
    print("Adam nu by group: port against JAX", by_group(r["nu"], r["jnu"]),
          "; JAX fp32 against bf16", by_group(f["jnu"], r["jnu"]))
    print("BN statistics: port against JAX",
          stats_error(r["model"].state_dict(), r["jnew"], r["before"]),
          "; JAX fp32 against bf16",
          stats_error(f["jnew"], r["jnew"], r["before"]))
    zero = {k: (0 * v if group(k) == "image backbone" else v)
            for k, v in r["grads"].items()}
    print("controls: stage-4 gradient zeroed",
          by_group(zero, r["jgrads"])["image backbone"], "reversed",
          by_group({k: -v for k, v in r["grads"].items()},
                   r["jgrads"])["image backbone"])


if __name__ == "__main__":
    torch.set_num_threads(1)
    readings(sys.argv[1], sys.argv[2:])
