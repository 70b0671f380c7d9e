"""The single-process case of the port's ``parallel/dist.py``: the
reference runs in one process, so every collective is the identity."""


def active():
    return False


def world_size():
    return 1


def all_reduce_sum(x):
    return x


def global_ratio(num, den):
    """num / max(den, 1): a mean over the batch."""
    return num / den.clamp(min=1.0)


def gather_rows(x):
    return x


def local_rows(x):
    return x
