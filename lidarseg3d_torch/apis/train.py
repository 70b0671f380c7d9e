"""Training API: train state, train step, eval step and checkpoints
(PyTorch port of the step functions and save_checkpoint / load_checkpoint
of lidarseg3d_tpu/apis/train.py; its epoch loop and hooks are not ported).

A train step is forward in training mode -> losses -> backward ->
global-norm clip / Adam / decoupled weight decay under the schedules
(solver/optim.py) -> updated parameters and BN running statistics, all in
place on the model the state holds.
"""

import os
from dataclasses import dataclass

import torch
from torch import nn

from ..parallel import dist
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
    opt_state: AdamState  # None in a weights-only (evaluation) state
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
    returns the gradients' global norm. A parameter of a frozen stage
    (``model.frozen_parameters()``) gets a zero gradient, so the update
    still decays it, as the JAX package's optimizer does to every
    parameter behind a ``stop_gradient``; any other parameter without a
    gradient is an error."""
    named = list(state.model.named_parameters())
    frozen = set(state.model.frozen_parameters())
    for n, p in named:
        if p.grad is None and n in frozen:
            p.grad = torch.zeros_like(p)
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


def save_checkpoint(work_dir, state, epoch):
    """Write ``state`` to ``work_dir/epoch_{epoch}``, one ``torch.save``
    file: {"step", "model": the model's state_dict (parameters and BN
    running statistics), "optimizer": {"count", "mu", "nu"} or None,
    "generator": the dropout generator's state or None}, and name it in
    ``work_dir/latest.txt``. Returns the file's path."""
    path = os.path.abspath(os.path.join(work_dir, f"epoch_{epoch}"))
    if dist.is_main_process():
        os.makedirs(work_dir, exist_ok=True)
        opt = state.opt_state
        torch.save({
            "step": int(state.step),
            "model": state.model.state_dict(),
            "optimizer": None if opt is None else {
                "count": int(opt.count), "mu": list(opt.mu),
                "nu": list(opt.nu)},
            "generator": (None if state.generator is None
                          else state.generator.get_state()),
        }, path)
        with open(os.path.join(work_dir, "latest.txt"), "w") as f:
            f.write(f"epoch_{epoch}\n")
    dist.barrier(f"ckpt_epoch_{epoch}")
    return path


def load_checkpoint(work_dir, state, epoch=None, partial=False):
    """Restore ``work_dir/epoch_{epoch}`` (``latest.txt`` when epoch is
    None) into ``state`` in place: read onto the CPU, then copied to the
    model's device. ``partial=True`` restores the weights, the BN running
    statistics and the step only (an evaluation load, as the JAX tool's
    weights-only restore). Returns (state, epoch)."""
    if epoch is None:
        with open(os.path.join(work_dir, "latest.txt")) as f:
            name = f.read().strip()
    else:
        name = f"epoch_{epoch}"
    ckpt = torch.load(os.path.join(work_dir, name), map_location="cpu",
                      weights_only=True)
    state.model.load_state_dict(ckpt["model"], strict=True)
    state.step = ckpt["step"]
    if not partial:
        saved, opt = ckpt["optimizer"], state.opt_state
        if saved is None or opt is None:
            raise ValueError(f"{name}: a full restore needs the optimizer "
                             "state in both the checkpoint and the state")
        opt.count = saved["count"]
        for dst, src in zip(opt.mu + opt.nu, saved["mu"] + saved["nu"],
                            strict=True):
            dst.copy_(src)
        if ckpt["generator"] is not None and state.generator is not None:
            state.generator.set_state(ckpt["generator"])
    return state, int(name.split("_")[1])
