"""Process-level helpers of evaluation and checkpointing (counterpart of
lidarseg3d_tpu/parallel/dist.py:46-65) for one process.

Multi-process runs (DDP) are not ported yet: every helper raises when
``torch.distributed`` is initialised with a world size above 1, instead of
reducing or writing from one rank only.
"""

import torch.distributed as tdist


def _single_process(what):
    if tdist.is_available() and tdist.is_initialized() \
            and tdist.get_world_size() > 1:
        raise NotImplementedError(
            f"{what}: multi-process runs are not ported to lidarseg3d_torch "
            f"yet (world size {tdist.get_world_size()}; ROADMAP A6)")


def is_main_process():
    _single_process("is_main_process")
    return True


def barrier(name="barrier"):
    _single_process(f"barrier {name!r}")


def allreduce_hist(hist):
    """The sum of a host-side array (a [C, C] confusion histogram) over all
    processes: the array itself in a single process."""
    _single_process("allreduce_hist")
    return hist
