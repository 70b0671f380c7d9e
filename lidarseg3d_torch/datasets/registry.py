"""Dataset and pipeline registries (own copy of
lidarseg3d_tpu/datasets/registry.py)."""

from ..utils.registry import Registry

DATASETS = Registry("dataset")
PIPELINES = Registry("pipeline")
