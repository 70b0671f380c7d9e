"""Rank-aware logging (own copy of lidarseg3d_tpu/utils/log.py; cf. det3d's
common_utils.create_logger)."""

import logging
import sys


def create_logger(log_file=None, rank=0, log_level=logging.INFO,
                  name="lidarseg3d_torch"):
    """A logger to stdout (and to ``log_file``, on rank 0 only) at
    ``log_level`` on rank 0 and ERROR elsewhere. A second call with the
    same name returns the first logger with its handlers."""
    logger = logging.getLogger(name)
    logger.setLevel(log_level if rank == 0 else logging.ERROR)
    logger.propagate = False
    if logger.handlers:
        return logger
    fmt = logging.Formatter("%(asctime)s  %(levelname)5s  %(message)s")
    sh = logging.StreamHandler(stream=sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_file is not None and rank == 0:
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger
