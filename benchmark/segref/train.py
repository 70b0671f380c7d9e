"""One training step of the reference, as the port's ``apis/train.py``
``make_train_step`` defines it: forward in training mode, the losses,
backward, zero gradients for the frozen stages, then the optimizer."""

import numpy as np
import torch

from .optim import build_one_cycle_optimizer

BATCH_KEYS = (
    "voxels", "coordinates", "num_points", "num_voxels", "points",
    "point_valid", "voxel_valid", "voxel_sem_labels", "point_sem_labels",
    "images", "points_cuv", "images_sem_labels",
)


def to_device(batch, device):
    """The host batch's model inputs as tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(device)
            for k in BATCH_KEYS if k in batch}


def build_optimizer(cfg, total_steps):
    clip = cfg["optimizer_config"].get("grad_clip", {}).get("max_norm", 35.0)
    tx, _ = build_one_cycle_optimizer(dict(cfg["optimizer"]),
                                      dict(cfg["lr_config"]), total_steps,
                                      grad_clip=clip)
    return tx


def train_step(model, tx, opt_state, batch, input_shape, generator):
    """-> the loss terms (detached). Updates the model and ``opt_state``
    in place."""
    ex = dict(batch, input_shape=tuple(input_shape))
    model.train()
    model.zero_grad(set_to_none=True)
    ret, bat = model(ex, generator=generator)
    loss, ldict = model.loss(ret, bat)
    loss.backward()
    named = list(model.named_parameters())
    frozen = set(model.frozen_parameters())
    for n, p in named:
        if p.grad is None and n in frozen:
            p.grad = torch.zeros_like(p)
    missing = [n for n, p in named if p.grad is None]
    if missing:
        raise RuntimeError(f"parameters without a gradient: {missing[:5]}")
    params = [p for _, p in named]
    tx.update(params, [p.grad for p in params], opt_state)
    return {k: v.detach() for k, v in ldict.items()}
