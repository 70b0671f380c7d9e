"""Training API: train state, train step and eval step (PyTorch port of
the step functions of lidarseg3d_tpu/apis/train.py; its epoch loop, hooks
and checkpoints are not ported).

A train step is forward in training mode -> losses -> backward ->
global-norm clip / Adam / decoupled weight decay under the schedules
(solver/optim.py) -> updated parameters and BN running statistics, all in
place on the model the state holds.
"""

from dataclasses import dataclass

import torch
from torch import nn

from ..solver.optim import AdamState
from ..synthetic import example_to_device as _to_device

DEVICE_BATCH_KEYS = (
    "voxels", "coordinates", "num_points", "num_voxels", "points",
    "point_valid", "voxel_valid", "voxel_sem_labels", "point_sem_labels",
    "images", "points_cuv", "images_sem_labels",
)


def example_to_device(batch, device):
    """The padded numpy batch's device keys as tensors on ``device``."""
    return _to_device({k: batch[k] for k in DEVICE_BATCH_KEYS if k in batch},
                      device)


@dataclass
class TrainState:
    step: int
    model: nn.Module
    opt_state: AdamState
    generator: torch.Generator  # the point head's dropout draws from it


def create_train_state(model, optimizer, seed=0):
    params = list(model.parameters())
    dev = params[0].device
    return TrainState(step=0, model=model, opt_state=optimizer.init(params),
                      generator=torch.Generator(device=dev).manual_seed(seed))


def forward_loss(state, batch, input_shape):
    """Forward in training mode and the losses, with the gradients of the
    last step cleared -> (total loss, dict of loss terms). The BN running
    statistics are updated here."""
    model = state.model
    ex = dict(batch)
    ex["input_shape"] = tuple(int(s) for s in input_shape)
    model.train()
    model.zero_grad(set_to_none=True)
    ret, bat = model(ex, generator=state.generator)
    return model.loss(ret, bat)


def apply_gradients(state, optimizer):
    """The optimizer's update from the parameters' ``.grad``, in place;
    returns the gradients' global norm."""
    named = list(state.model.named_parameters())
    missing = [n for n, p in named if p.grad is None]
    if missing:
        raise RuntimeError(f"parameters without a gradient: {missing[:5]}")
    params = [p for _, p in named]
    norm = optimizer.update(params, [p.grad for p in params],
                            state.opt_state)
    state.step += 1
    return norm


def make_train_step(model, optimizer, input_shape):
    """-> train_step(state, batch) -> (state, loss dict with "grad_norm").
    ``state.model`` must be ``model``; the update is in place."""

    def train_step(state, batch):
        if state.model is not model:
            raise ValueError("the train state holds another model")
        loss, ldict = forward_loss(state, batch, input_shape)
        loss.backward()
        ldict = {k: v.detach() for k, v in ldict.items()}
        ldict["grad_norm"] = apply_gradients(state, optimizer)
        return state, ldict

    return train_step


def make_eval_step(model, input_shape):
    def eval_step(state, batch):
        ex = dict(batch)
        ex["input_shape"] = tuple(int(s) for s in input_shape)
        m = state.model.eval()
        ret, bat = m(ex)
        return m.predict(ret, bat)

    return eval_step
