"""The optimizer and its OneCycle schedules: a frozen copy of the port's
``solver/optim.py`` without the multi-step fallback.

Adam(betas=(b1, 0.99)) with decoupled weight decay on every parameter (BN
included), a global-norm gradient clip, and the OneCycle schedule that
cosine-anneals lr low -> max -> low/1e4 and beta1 0.95 -> 0.85 -> 0.95.

``ChainedAdam`` spells out the JAX package's optax chain, in its order:

    g  <- g / ||g|| * clip           only when ||g|| >= clip
    mu <- b1 mu + (1 - b1) g ;  nu <- b2 nu + (1 - b2) g^2
    u  <- (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)
    u  <- u + wd * p
    p  <- p - lr * u

with t the step count after the increment, and lr and b1 read from their
schedules at the count before it (the first step uses ``lr_fn(0)``); the
bias correction uses the current scheduled b1.
"""

import math
from dataclasses import dataclass

import torch


def annealing_cos(start, end, pct):
    cos_out = math.cos(math.pi * pct) + 1.0
    return end + (start - end) / 2.0 * cos_out


def _phases(step, total_steps, pct_start):
    split = pct_start * total_steps
    p1 = min(max(step / max(split, 1.0), 0.0), 1.0)
    p2 = min(max((step - split) / max(total_steps - split, 1.0), 0.0), 1.0)
    return step < split, p1, p2


def one_cycle_lr_fn(total_steps, lr_max, div_factor=10.0, pct_start=0.4):
    low_lr = lr_max / div_factor

    def lr(step):
        rising, p1, p2 = _phases(float(step), total_steps, pct_start)
        return (annealing_cos(low_lr, lr_max, p1) if rising
                else annealing_cos(lr_max, low_lr / 1e4, p2))

    return lr


def one_cycle_mom_fn(total_steps, moms=(0.95, 0.85), pct_start=0.4):
    def mom(step):
        rising, p1, p2 = _phases(float(step), total_steps, pct_start)
        return (annealing_cos(moms[0], moms[1], p1) if rising
                else annealing_cos(moms[1], moms[0], p2))

    return mom


@dataclass
class AdamState:
    count: int
    mu: list
    nu: list


class ChainedAdam:
    """The chain of the module docstring over a list of parameters. The
    update is in place on the parameters and on the state; the gradients
    are left as they came."""

    def __init__(self, lr_fn, b1_fn, b2, eps=1e-8, wd=0.0, grad_clip=35.0):
        self.lr_fn, self.b1_fn = lr_fn, b1_fn
        self.b2, self.eps, self.wd, self.grad_clip = b2, eps, wd, grad_clip

    def init(self, params):
        return AdamState(count=0, mu=[torch.zeros_like(p) for p in params],
                         nu=[torch.zeros_like(p) for p in params])

    @staticmethod
    def global_norm(grads):
        return torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))

    @torch.no_grad()
    def update(self, params, grads, state):
        """One step; returns the global norm of ``grads`` (before the
        clip) as a 0-d tensor."""
        norm = self.global_norm(grads)
        if self.grad_clip:
            clip = torch.full_like(norm, self.grad_clip)
            one = torch.ones_like(norm)
            keep = norm < clip
            grads = torch._foreach_div(grads, torch.where(keep, one, norm))
            torch._foreach_mul_(grads, torch.where(keep, one, clip))
        lr, b1, b2 = self.lr_fn(state.count), self.b1_fn(state.count), self.b2
        state.count += 1
        torch._foreach_mul_(state.mu, b1)
        torch._foreach_add_(state.mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(state.nu, b2)
        torch._foreach_addcmul_(state.nu, grads, grads, value=1.0 - b2)
        denom = torch._foreach_div(state.nu, 1.0 - b2 ** state.count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(state.mu, 1.0 - b1 ** state.count)
        torch._foreach_div_(upd, denom)
        if self.wd:
            torch._foreach_add_(upd, params, alpha=self.wd)
        torch._foreach_add_(params, upd, alpha=-lr)
        return norm


def build_one_cycle_optimizer(optimizer_cfg, lr_cfg, total_steps,
                              grad_clip=35.0):
    """cfg mirrors the reference config keys:
    optimizer = dict(type="adam", amsgrad=0.0, wd=0.01, fixed_wd=True, ...)
    lr_config = dict(type="one_cycle", lr_max, moms, div_factor, pct_start)
    -> (ChainedAdam, lr_fn)."""
    assert optimizer_cfg.get("type", "adam") == "adam"
    pct = lr_cfg.get("pct_start", 0.4)
    lr_fn = one_cycle_lr_fn(total_steps, lr_cfg["lr_max"],
                            lr_cfg.get("div_factor", 10.0), pct)
    mom_fn = one_cycle_mom_fn(total_steps,
                              tuple(lr_cfg.get("moms", (0.95, 0.85))), pct)
    return ChainedAdam(lr_fn, mom_fn, b2=0.99, wd=optimizer_cfg.get("wd", 0.0),
                       grad_clip=grad_clip), lr_fn

