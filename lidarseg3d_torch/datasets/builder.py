"""build_dataset (own copy of lidarseg3d_tpu/datasets/builder.py)."""

from ..utils.registry import build_from_cfg
from .registry import DATASETS


def build_dataset(cfg, default_args=None):
    return build_from_cfg(cfg, DATASETS, default_args)
