"""Multi-process runtime of training and evaluation (the port's counterpart
of lidarseg3d_tpu/parallel/dist.py): one process per card, a
``torch.distributed`` process group between them.

The JAX package runs one SPMD program over the global batch, so a step on
N processes of B frames each is the step one process takes on the N*B
frames. The port keeps that contract with explicit collectives, each a
no-op while no process group is up:

- ``all_reduce_sum`` is a sum over the ranks whose backward is the same
  sum, so a statistic or a loss term built from it carries its gradient
  to every rank's inputs (batch norm over the global batch, the losses'
  global normalisations);
- ``gather_rows`` stacks every rank's rows in rank order, the global
  batch's row order (Lovász's sort over all points);
- ``local_rows`` keeps this rank's rows of a tensor drawn for the global
  batch (dropout masks drawn from a generator that is identical on every
  rank).

Evaluation sums [C, C] confusion histograms (``allreduce_hist``);
checkpoints are written by rank 0 (``is_main_process``) behind a
``barrier``. While a process group is up the collectives run even for a
single rank, so a one-rank group computes what no group computes, bit
for bit.
"""

import os

import numpy as np
import torch
import torch.distributed as tdist


def active():
    """Whether a process group is up (the collectives then run)."""
    return tdist.is_available() and tdist.is_initialized()


def rank():
    return tdist.get_rank() if active() else 0


def world_size():
    return tdist.get_world_size() if active() else 1


def is_main_process():
    return rank() == 0


def _flag_or_env(value, name, cast=str):
    if value is not None:
        return value
    env = os.environ.get(name)
    return None if env in (None, "") else cast(env)


def init_distributed(coordinator=None, num_processes=None, process_id=None,
                     device="cuda", share_card=False):
    """Start the process group that the tools' ``--dist_*`` flags ask for,
    or that torchrun's ``WORLD_SIZE`` / ``RANK`` / ``MASTER_ADDR`` /
    ``MASTER_PORT`` describe (as the JAX package reads its ``JAX_*``
    variables); returns ``(rank, world_size)``. The entry points print
    each rank's backend and device.

    ``coordinator`` is rank 0's ``host:port`` or an init URL
    (``tcp://...``, ``file://...``). Nothing happens when no flag is
    given and the environment names no world size (a plain single-process
    run), nor when a group is already up; an incomplete set raises. The backend is
    NCCL for ranks on their own cards and gloo on the CPU or for ranks
    that share one card (``share_card``: NCCL ranks never share one). Each
    rank's device comes from ``rank_device``; CUDA ranks bind it before
    the group starts. A failed start raises: nothing carries on as one
    process."""
    if active():
        return rank(), world_size()
    world = _flag_or_env(num_processes, "WORLD_SIZE", int)
    if world is None and coordinator is None and process_id is None:
        return 0, 1
    proc = _flag_or_env(process_id, "RANK", int)
    if coordinator is None and os.environ.get("MASTER_ADDR"):
        coordinator = (f"{os.environ['MASTER_ADDR']}:"
                       f"{os.environ.get('MASTER_PORT', '29500')}")
    if world is None or coordinator is None or proc is None:
        raise ValueError(
            "a multi-process run needs a coordinator, a process count and "
            f"a process id (got {coordinator!r}, {world!r}, {proc!r})")
    if not 0 <= proc < world:
        raise ValueError(f"process id {proc} outside a world of {world}")
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    on_card = torch.device(device).type == "cuda"
    backend = "nccl" if on_card and not share_card else "gloo"
    dev = rank_device(device, share_card, proc)
    if on_card:
        torch.cuda.set_device(dev)
    tdist.init_process_group(backend, init_method=url, world_size=world,
                             rank=proc)
    return proc, world


def rank_device(device="cuda", share_card=False, proc=None):
    """This rank's device: the CPU, or the card of its local rank
    (torchrun's ``LOCAL_RANK``, else the rank modulo the host's cards),
    or card 0 for every rank under ``share_card``. A rank without a card
    of its own raises."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA rank needs a card, and "
                           "torch.cuda.is_available() is False")
    proc = rank() if proc is None else proc
    count = torch.cuda.device_count()
    if share_card:
        return torch.device("cuda", 0)
    local = int(os.environ.get("LOCAL_RANK", proc % count))
    if local >= count:
        raise RuntimeError(f"local rank {local} has no card of its own "
                           f"({count} cards); ranks share a card only when "
                           "asked to")
    return torch.device("cuda", local)


def shutdown():
    """End the process group, if one is up."""
    if active():
        tdist.destroy_process_group()


def barrier(name="barrier"):
    if active():
        tdist.barrier()


def _comm_device():
    """Where host data goes for a collective: the bound card under NCCL,
    the CPU under gloo."""
    if tdist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def allreduce_hist(hist):
    """The sum over all processes of a host-side array (a [C, C]
    confusion histogram); the array itself without a process group."""
    if not active():
        return hist
    arr = np.asarray(hist)
    t = torch.from_numpy(np.ascontiguousarray(arr)).to(_comm_device())
    tdist.all_reduce(t)
    return t.cpu().numpy()


def gather_to_main(obj):
    """Every rank's picklable ``obj``, in rank order, on rank 0 (None on
    the others); ``[obj]`` without a process group."""
    if not active():
        return [obj]
    out = [None] * world_size() if is_main_process() else None
    tdist.gather_object(obj, out, dst=0)
    return out


class _AllReduceSum(torch.autograd.Function):
    """y = sum over ranks of x, on every rank; the adjoint of that is the
    sum over ranks of dy."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone(memory_format=torch.contiguous_format)
        tdist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, dy):
        dx = dy.clone(memory_format=torch.contiguous_format)
        tdist.all_reduce(dx)
        return dx


def all_reduce_sum(x):
    """The sum of ``x`` over the ranks, differentiable; ``x`` itself
    without a process group."""
    return _AllReduceSum.apply(x) if active() else x


def global_ratio(num, den):
    """num / max(den, 1) with both scalars summed over the ranks first:
    a mean over the global batch (a loss term's normalisation)."""
    if active():
        num, den = all_reduce_sum(torch.stack([num, den.to(num.dtype)]))
    return num / den.clamp(min=1.0)


def gather_rows(x):
    """Every rank's ``x`` (the same shape on each) stacked in rank order
    along dim 0, differentiable; ``x`` itself without a process group.
    Built as a sum of zero-padded per-rank slots, so the rows arrive
    exactly."""
    if not active():
        return x
    slots = [x if r == rank() else torch.zeros_like(x)
             for r in range(world_size())]
    return all_reduce_sum(torch.stack(slots)).flatten(0, 1)


def local_rows(x):
    """This rank's share of ``x``'s rows: x holds the global batch (every
    rank's rows in rank order, equal counts)."""
    w = world_size()
    if w == 1:
        return x
    n = x.shape[0] // w
    return x[rank() * n:(rank() + 1) * n]
