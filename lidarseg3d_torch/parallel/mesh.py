"""The data-parallel state of a multi-process run (the roles of
lidarseg3d_tpu/parallel/mesh.py's ``replicate_tree`` and the gradient
reduction that XLA's SPMD inserts there): each rank holds the whole
model, its own rows of the global batch stay on its card, and

- ``broadcast_state`` copies rank 0's parameters, buffers (the BN running
  statistics) and optimizer moments to every rank, so all ranks start
  from one state;
- ``allreduce_gradients`` turns each rank's gradients into the gradient
  of the global batch's loss. Every rank back-propagates the same global
  loss through collectives whose backward sums over the ranks
  (parallel/dist.py), so the rank gradients add up to N times the
  gradient: they are summed and divided by N. One flattened all-reduce
  per dtype, after the backward and in parameter order, so the recomputed
  regions of the backward (utils/remat.py) meet no per-parameter hook and
  every rank reduces in the same order.

Without a process group both are no-ops.
"""

import torch

from . import dist


def _by_dtype(tensors):
    groups = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    return groups.values()


def _flat_collective(tensors, op):
    """``op`` on one flat buffer per dtype, the results copied back."""
    for group in _by_dtype(tensors):
        flat = torch.cat([t.reshape(-1) for t in group])
        op(flat)
        for t, part in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(part.view_as(t))


@torch.no_grad()
def broadcast_state(state):
    """Rank 0's model parameters and buffers and, when the state has
    them, its Adam moments, on every rank (in place)."""
    if not dist.active():
        return state
    import torch.distributed as tdist

    tensors = list(state.model.parameters()) + list(state.model.buffers())
    opt = state.opt_state
    if opt is not None:
        tensors += list(opt.mu) + list(opt.nu)
    _flat_collective(tensors, lambda flat: tdist.broadcast(flat, src=0))
    return state


@torch.no_grad()
def allreduce_gradients(model):
    """Each parameter's ``.grad`` summed over the ranks and divided by
    their count (see the module docstring); a parameter without a
    gradient (a frozen stage) has none on every rank and is left alone."""
    if not dist.active():
        return
    import torch.distributed as tdist

    grads = [p.grad for p in model.parameters() if p.grad is not None]
    n = dist.world_size()

    def reduce(flat):
        tdist.all_reduce(flat)
        flat.div_(n)

    _flat_collective(grads, reduce)
