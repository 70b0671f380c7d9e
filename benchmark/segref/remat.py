"""Activation rematerialization: the port's counterpart of the JAX
package's ``nn.remat`` (UNetSCN3D's and the SFFM decoder's ``ACT_REMAT``,
HRNet's ``with_cp``).

``remat(fn, *args)`` runs ``fn`` under ``torch.utils.checkpoint``
(non-reentrant): its activations are dropped after the forward and ``fn``
runs again when the backward needs them. Two things must not happen twice
or differently in that second run, and the region's phase tells the code
inside it which run it is in (``phase()``):

- BN running statistics: JAX's functional remat moves them once, so
  ``MaskedBatchNorm`` leaves them alone while ``phase() == "recompute"``;
- randomness from an explicit ``torch.Generator`` (the point head's
  dropout), which ``preserve_rng_state`` does not restore: such draws
  refuse to run inside a region at all.

The phase is kept per thread: the autograd engine may run the recompute on
its own device thread, and it enters and leaves the phase there.
"""

import threading
from contextlib import contextmanager

import torch
from torch.utils import checkpoint

_region = threading.local()


def phase():
    """None outside a recomputed region; "forward" while the region runs
    the first time; "recompute" while the backward runs it again."""
    return getattr(_region, "phase", None)


@contextmanager
def _phase(name):
    prev = phase()
    _region.phase = name
    try:
        yield
    finally:
        _region.phase = prev


def remat(fn, *args):
    """``fn(*args)``, recomputed in the backward when gradients are being
    recorded; a plain call otherwise (evaluation records no graph)."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=True,
        context_fn=lambda: (_phase("forward"), _phase("recompute")))
