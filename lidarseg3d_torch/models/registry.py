"""Model registries (own copy of lidarseg3d_tpu/models/registry.py)."""

from ..utils.registry import Registry

READERS = Registry("reader")
BACKBONES = Registry("backbone")
POINT_HEADS = Registry("point_head")
IMG_BACKBONES = Registry("img_backbone")
IMG_HEADS = Registry("img_head")
DETECTORS = Registry("detector")
