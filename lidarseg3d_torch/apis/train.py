"""Training API: train state, train step, eval step, checkpoints and the
epoch loop with its hooks (PyTorch port of lidarseg3d_tpu/apis/train.py).

A train step is forward in training mode -> losses -> backward ->
global-norm clip / Adam / decoupled weight decay under the schedules
(solver/optim.py) -> updated parameters and BN running statistics, all in
place on the model the state holds. ``train_segmentor`` runs the epochs:
OneCycle over every step, a log line every ``log_interval`` steps, a
checkpoint after each epoch, resume, validation and ``TrainerHook``
events in the JAX package's order, and optionally TensorBoard scalars
and a torch.profiler trace of five steps.

In a multi-process run (parallel/dist.py) every rank runs the loop on its
shard of each batch: the state is broadcast from rank 0 before the first
step, the gradients are reduced after each backward (parallel/mesh.py),
so every rank applies the global batch's update and the parameters stay
identical; rank 0 alone logs, writes TensorBoard events, traces and
writes checkpoints.
"""

import os
import time
from dataclasses import dataclass

import torch
from torch import nn

from ..parallel import dist, mesh
from ..solver.optim import AdamState, build_one_cycle_optimizer
from ..synthetic import example_to_device as _to_device
from ..utils.spans import span


class TrainerHook:
    """Extension point of the training loop: each method may return a
    new state (or None to keep it) and may raise ``StopTraining``. Built-in
    behaviour (logging, checkpoints, validation) stays inline; hooks add
    behaviour (EMA, custom evaluation, early stop)."""

    def before_run(self, state, loop):  # loop: dict of loop constants
        return state

    def before_epoch(self, state, epoch):
        return state

    def after_iter(self, state, ldict, global_step):
        return state

    def after_epoch(self, state, epoch):
        return state

    def after_run(self, state):
        return state


class StopTraining(Exception):
    """Raise from a hook to end training cleanly: from ``after_iter`` the
    epoch ends at once (its checkpoint, validation and ``after_epoch``
    still run), from ``before_epoch`` training ends before that epoch."""

DEVICE_BATCH_KEYS = (
    "voxels", "coordinates", "num_points", "num_voxels", "points",
    "point_valid", "voxel_valid", "voxel_sem_labels", "point_sem_labels",
    "images", "points_cuv", "images_sem_labels",
)


def example_to_device(batch, device):
    """The padded numpy batch's device keys as tensors on ``device``; a
    detection batch's ``det_targets`` (a dict of arrays per task) and
    ``gt_boxes_and_cls`` too, which the JAX package's DEVICE_BATCH_KEYS
    leave on the host (so its tools cannot train a detector)."""
    with span("to_device"):
        ex = _to_device({k: batch[k] for k in DEVICE_BATCH_KEYS
                         + ("gt_boxes_and_cls",) if k in batch}, device)
        if "det_targets" in batch:
            ex["det_targets"] = [_to_device(t, device)
                                 for t in batch["det_targets"]]
        return ex


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


def _grid(input_shape):
    """The example's input_shape: the host voxel grid, or None where the
    model voxelizes the points itself."""
    return None if input_shape is None else tuple(int(s) for s in
                                                  input_shape)


def forward_loss(state, batch, input_shape):
    """Forward in training mode and the losses, with the gradients of the
    last step cleared -> (total loss, dict of loss terms). The BN running
    statistics are updated here."""
    model = state.model
    ex = dict(batch)
    ex["input_shape"] = _grid(input_shape)
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
    with span("optimizer"):
        named = list(state.model.named_parameters())
        frozen = set(state.model.frozen_parameters())
        for n, p in named:
            if p.grad is None and n in frozen:
                p.grad = torch.zeros_like(p)
        missing = [n for n, p in named if p.grad is None]
        if missing:
            raise RuntimeError(
                f"parameters without a gradient: {missing[:5]}")
        params = [p for _, p in named]
        norm = optimizer.update(params, [p.grad for p in params],
                                state.opt_state)
        state.step += 1
        return norm


def make_train_step(model, optimizer, input_shape):
    """-> train_step(state, batch) -> (state, loss dict with "grad_norm").
    ``state.model`` must be ``model``; the update is in place. In a
    multi-process run ``batch`` is this rank's rows, and the step is the
    global batch's (the module docstring)."""

    def train_step(state, batch):
        if state.model is not model:
            raise ValueError("the train state holds another model")
        with span("step"):
            loss, ldict = forward_loss(state, batch, input_shape)
            with span("backward"):
                loss.backward()
            mesh.allreduce_gradients(model)
            ldict = {k: v.detach() for k, v in ldict.items()}
            ldict["grad_norm"] = apply_gradients(state, optimizer)
            return state, ldict

    return train_step


def make_eval_step(model, input_shape):
    def eval_step(state, batch):
        with span("step"):
            ex = dict(batch)
            ex["input_shape"] = _grid(input_shape)
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


def _fire(hooks, event, state, *args):
    """Call ``event`` on every hook, each even after one raised
    StopTraining; -> (state, whether one did)."""
    stop = False
    for h in hooks:
        try:
            state = getattr(h, event)(state, *args) or state
        except StopTraining:
            stop = True
    return state, stop


def _profile_window(total_steps):
    """The global steps the profiler traces: 10-14 as in the JAX loop, or
    the last five of a shorter run."""
    first = max(min(10, total_steps - 5), 0)
    return first, min(first + 4, total_steps - 1)


class _StepProfiler:
    """torch.profiler over the global steps ``_profile_window`` names; the
    trace is written to ``profile_dir`` as a Chrome trace when the window
    ends (or the loop does). It shows the steps' layer spans
    (utils/spans.py)."""

    def __init__(self, profile_dir, total_steps, device):
        from torch.profiler import ProfilerActivity, profile

        self.dir = profile_dir
        self.first, self.last = _profile_window(total_steps)
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else [])
        self.prof = profile(activities=acts)
        self.running = False

    def before(self, global_step):
        if global_step == self.first:
            os.makedirs(self.dir, exist_ok=True)
            self.prof.start()
            self.running = True

    def after(self, global_step):
        if self.running and global_step >= self.last:
            self.stop()

    def stop(self):
        if self.running:
            self.prof.stop()
            self.running = False
            self.prof.export_chrome_trace(os.path.join(
                self.dir, f"trace_steps_{self.first}-{self.last}.json"))


def train_segmentor(model, loader, input_shape, optimizer_cfg, lr_cfg,
                    total_epochs, work_dir, logger, grad_clip=35.0,
                    log_interval=5, resume_from=None, seed=0, val_fn=None,
                    init_hook=None, tb_log_dir=None, profile_dir=None,
                    hooks=(), timings=None):
    """The epoch loop (the JAX package's train_segmentor). The model
    already holds its parameters (build_detector), so the loop starts from
    ``create_train_state`` (the dropout generator seeded with ``seed``),
    then ``init_hook(state)``; ``resume_from`` -1 (or True) restores the
    checkpoint ``latest.txt`` names, N restores ``epoch_N``, and the
    global step and the schedule continue from there. After each epoch
    the state is saved as ``work_dir/epoch_{e}``, then ``val_fn(state,
    e)`` runs. ``timings``, a list, receives for each step the seconds the
    loop waited for its batch (taken from the loader and copied to the
    device) and the seconds of the step itself, measured to a device
    synchronisation. ``tb_log_dir``: each log line's scalars (and the
    learning rate) also go to TensorBoard event files there;
    ``profile_dir``: a torch.profiler trace of global steps 10-14 (the
    last five of a shorter run) is written there. Returns the state."""
    os.makedirs(work_dir, exist_ok=True)
    main = dist.is_main_process()
    tb = None
    if tb_log_dir and main:
        from ..utils.tb_logger import TensorboardLogger

        tb = TensorboardLogger(tb_log_dir)
    steps_per_epoch = loader.steps_per_epoch()
    total_steps = steps_per_epoch * total_epochs
    optimizer, lr_fn = build_one_cycle_optimizer(
        optimizer_cfg, lr_cfg, total_steps, grad_clip=grad_clip)
    device = next(model.parameters()).device
    state = create_train_state(model, optimizer, seed=seed)
    if init_hook is not None:
        state = init_hook(state)
    n_params = sum(p.numel() for p in model.parameters())
    if main:
        logger.info(f"model params: {n_params / 1e6:.2f} M; steps/epoch: "
                    f"{steps_per_epoch}; total steps: {total_steps}")

    start_epoch = 0
    if resume_from is not None:  # every rank reads the checkpoint
        epoch_sel = None if resume_from in (-1, True) else resume_from
        state, start_epoch = load_checkpoint(work_dir, state, epoch_sel)
        if main:
            logger.info(f"resumed from epoch {start_epoch}")
    state = mesh.broadcast_state(state)
    train_step = make_train_step(model, optimizer, input_shape)
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else lambda *a: None)
    prof = (None if not (profile_dir and main)
            else _StepProfiler(profile_dir, total_steps, device))

    loop = dict(total_epochs=total_epochs, steps_per_epoch=steps_per_epoch,
                work_dir=work_dir, lr_fn=lr_fn)
    for h in hooks:
        state = h.before_run(state, loop) or state
    t_start = time.time()
    global_step = start_epoch * steps_per_epoch
    for epoch in range(start_epoch, total_epochs):
        state, stop = _fire(hooks, "before_epoch", state, epoch)
        if stop:
            break
        buf, t_data, t_iter = {}, 0.0, time.time()
        t_ready = time.perf_counter()  # from here the loop waits for data
        for it, batch in enumerate(loader.epoch(epoch)):
            dev_batch = example_to_device(batch, device)
            t0 = time.perf_counter()
            t_data += t0 - t_ready
            if prof is not None:
                prof.before(global_step)
            state, ldict = train_step(state, dev_batch)
            if prof is not None:
                sync(device)
                prof.after(global_step)
            if timings is not None:
                sync(device)
                timings.append(dict(data_s=t0 - t_ready,
                                    step_s=time.perf_counter() - t0))
            state, stop = _fire(hooks, "after_iter", state, ldict,
                                global_step)
            global_step += 1
            if stop:
                break
            if not main:  # rank 0 logs the global loss terms
                t_ready = time.perf_counter()
                continue
            for k, v in ldict.items():
                buf.setdefault(k, []).append(v)
            if (it + 1) % log_interval == 0:
                vals = {k: float(torch.stack(v).float().mean())
                        for k, v in buf.items()}
                lr = float(lr_fn(global_step))
                elapsed = time.time() - t_start
                done = global_step - start_epoch * steps_per_epoch
                eta = elapsed / max(done, 1) * (total_steps - global_step)
                msg = ", ".join(f"{k}: {v:.4f}" for k, v in vals.items())
                logger.info(
                    f"Epoch [{epoch + 1}/{total_epochs}][{it + 1}/"
                    f"{steps_per_epoch}] lr: {lr:.5f}, eta: "
                    f"{eta / 60:.1f}min, data: {t_data:.2f}s, iter: "
                    f"{time.time() - t_iter:.2f}s, {msg}")
                if tb is not None:
                    tb.log_scalars({"lr": lr, **vals}, global_step)
                buf, t_data, t_iter = {}, 0.0, time.time()
            t_ready = time.perf_counter()
        save_checkpoint(work_dir, state, epoch + 1)
        if main:
            logger.info(f"saved checkpoint epoch_{epoch + 1}")
        if val_fn is not None:
            val_fn(state, epoch + 1)
        state, stop_after = _fire(hooks, "after_epoch", state, epoch + 1)
        if stop or stop_after:
            break
    if prof is not None:
        prof.stop()
    if tb is not None:
        tb.close()
    for h in hooks:
        state = h.after_run(state) or state
    return state
