"""build_* helpers (PyTorch port of lidarseg3d_tpu/models/builder.py).

``build_detector`` is the port's entry point: it takes the JAX package's
config dicts, builds the model on ``device`` (``cuda`` unless the caller
passes another), initializes it from a seeded ``torch.Generator`` and
returns it in eval mode.
"""

import torch

from ..utils.device import resolve_device
from ..utils.registry import build_from_cfg
from . import registry
from .layers import init_parameters


def build_reader(cfg):
    return build_from_cfg(cfg, registry.READERS)


def build_backbone(cfg):
    return build_from_cfg(cfg, registry.BACKBONES)


def build_point_head(cfg):
    return build_from_cfg(cfg, registry.POINT_HEADS)


def build_img_backbone(cfg):
    return build_from_cfg(cfg, registry.IMG_BACKBONES)


def build_img_head(cfg):
    return build_from_cfg(cfg, registry.IMG_HEADS)


def build_detector(cfg, device=None, seed=0):
    dev = resolve_device(device)
    model = build_from_cfg(cfg, registry.DETECTORS)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()
