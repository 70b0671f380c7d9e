"""Train a segmentor with the port (the port's counterpart of
tools/train.py).

    python -m lidarseg3d_torch.tools.train CONFIG [--work_dir D]
        [--resume_from [N]] [--seed N] [--total_epochs N] [--batch_size N]
        [--max_steps_per_epoch N] [--validate] [--autoscale-lr]
        [--device cuda|cpu] [--dist_coordinator HOST:PORT|URL
        --dist_num_processes N --dist_process_id I] [--dist_share_card]
    torchrun --nproc_per_node N -m lidarseg3d_torch.tools.train CONFIG ...

The model is built from the config (seeded with ``--seed``), the config's
train split runs through the port's dataset, train pipeline and loader
(the config's ``worker_mode``, else ``shm`` workers on a host with more
than two CPUs, as in the JAX tool) into ``apis.train.train_segmentor``:
OneCycle over every step, the config's gradient clip, a log line every
``log_config.interval`` steps (also written to ``WORK_DIR/train.log``), a
checkpoint ``WORK_DIR/epoch_N`` after each epoch and ``latest.txt``.
``--resume_from`` alone resumes from ``latest.txt``, ``--resume_from N``
from ``epoch_N``. ``--validate`` evaluates the val split after each epoch
and logs its mIoU (a detector's: its frames and valid boxes). Detection
configs (VoxelNet, PointPillars) train the same way, their CenterPoint
targets assigned by the train pipeline and carried to the card with the
batch. ``--autoscale-lr`` scales ``lr_max`` by the cards
used / 8. The device is ``cuda`` unless ``--device cpu`` is given, and
the tool raises when there is no card.

Multi-process training: one process per card, started by torchrun or
with the ``--dist_*`` flags on every process (the JAX tool's names;
``parallel.dist.init_distributed``). Each process trains on its shard of
every epoch with ``samples_per_gpu`` frames a step, and the step is the
global batch's (``apis.train``): batch norm and the losses over all
processes' frames, the gradients reduced, the parameters identical on
every process. NCCL joins ranks on their own cards; ``--dist_share_card``
puts every rank on card 0 over gloo (ranks never share a card unless
asked to), and ``--device cpu`` runs gloo ranks on the CPU. Rank 0 logs,
writes ``train.log``, TensorBoard events, the trace and the checkpoints;
every rank reads a resume.

The image backbone's ``pretrained`` HRNet (a flax msgpack, as
``tools/convert_hrnet_checkpoint.py`` writes it from an mmcv state_dict)
is grafted in after the train state is made and before a resume, as the
JAX tool does (``apis.pretrain.load_hrnet_pretrained``; the log reports
the tensors loaded, skipped and unexpected); a file that does not exist
is skipped with a warning. ``--tb_log_dir`` writes the logged scalars to
TensorBoard event files, ``--profile_dir`` a torch.profiler trace of five
steps (see ``apis.train.train_segmentor``).
"""

import argparse
import copy
import logging
import os
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train a segmentor")
    p.add_argument("config", help="config file path")
    p.add_argument("--work_dir", default=None)
    p.add_argument("--resume_from", default=None, type=int, nargs="?",
                   const=-1)
    p.add_argument("--seed", default=None, type=int)
    p.add_argument("--total_epochs", default=None, type=int)
    p.add_argument("--batch_size", default=None, type=int)
    p.add_argument("--max_steps_per_epoch", default=None, type=int,
                   help="truncate each epoch to its first N batches")
    p.add_argument("--validate", action="store_true",
                   help="evaluate the val split after each epoch")
    p.add_argument("--autoscale-lr", action="store_true",
                   help="scale lr_max by the cards used / 8")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--tb_log_dir", default=None)
    p.add_argument("--profile_dir", default=None)
    add_dist_args(p)
    return p.parse_args(argv)


def add_dist_args(p):
    """The multi-process flags of both tools."""
    p.add_argument("--dist_coordinator", default=None,
                   help="rank 0's host:port (or an init URL); also read "
                   "from torchrun's MASTER_ADDR / MASTER_PORT")
    p.add_argument("--dist_num_processes", default=None, type=int,
                   help="also read from WORLD_SIZE")
    p.add_argument("--dist_process_id", default=None, type=int,
                   help="also read from RANK")
    p.add_argument("--dist_share_card", action="store_true",
                   help="every rank on card 0, joined over gloo")


def start_ranks(args):
    """Start the process group the flags (or torchrun) ask for -> (rank,
    world size, this rank's device, the cards in use)."""
    from ..parallel import dist
    from ..utils.device import resolve_device

    resolve_device(args.device)  # raises without a card
    rank, world = dist.init_distributed(
        args.dist_coordinator, args.dist_num_processes, args.dist_process_id,
        device=args.device, share_card=args.dist_share_card)
    device = dist.rank_device(args.device, args.dist_share_card)
    if dist.active():
        import torch.distributed as tdist

        print(f"rank {rank} of {world}: backend {tdist.get_backend()}, "
              f"device {device}", flush=True)
    cards = 1 if args.dist_share_card else world
    return rank, world, device, cards


def _logger(log_file):
    """The tool's logger, to stdout and ``log_file`` (None: stdout only,
    warnings and errors only: a rank other than 0); returns it and the
    file handler to close (or None)."""
    logger = logging.getLogger("lidarseg3d_torch.tools.train")
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    fmt = logging.Formatter("%(message)s")
    stream = logging.StreamHandler(sys.stdout)
    stream.setFormatter(fmt)
    logger.addHandler(stream)
    to_file = None
    if log_file is not None:
        to_file = logging.FileHandler(log_file)
        to_file.setFormatter(fmt)
        logger.addHandler(to_file)
    logger.setLevel(logging.INFO if log_file is not None else
                    logging.WARNING)
    logger.propagate = False
    return logger, to_file


class _FirstBatches:
    """A sampler's first ``n`` batches of every epoch
    (``--max_steps_per_epoch``)."""

    def __init__(self, sampler, n):
        self.sampler, self.n = sampler, n

    def epoch_indices(self, epoch):
        return self.sampler.epoch_indices(epoch)[: self.n]

    def steps_per_epoch(self):
        return min(self.sampler.steps_per_epoch(), self.n)


def main(argv=None, hooks=(), timings=None):
    """Run the training; ``hooks`` (TrainerHook instances) and
    ``timings`` (a list for each step's data wait and step seconds) go to
    ``train_segmentor``. Returns {"state": the final train state,
    "work_dir"}. A process group this call starts ends with it."""
    from ..parallel import dist

    args = parse_args(argv)
    owner = not dist.active()
    try:
        return _train(args, *start_ranks(args), hooks, timings)
    finally:
        if owner:
            dist.shutdown()


def _train(args, rank, world, device, cards, hooks, timings):
    from ..apis.eval import evaluate_dataset, run_eval
    from ..apis.train import train_segmentor
    from ..datasets import SegDataLoader, build_dataset, default_worker_mode
    from ..models import build_detector
    from ..utils.config import Config
    from .test import DET_TYPES, input_shape_of, model_config

    cfg = Config.fromfile(args.config)
    work_dir = args.work_dir or cfg.get("work_dir", "./work_dirs/default")
    os.makedirs(work_dir, exist_ok=True)
    logger, log_file = _logger(os.path.join(work_dir, "train.log")
                               if rank == 0 else None)
    try:
        logger.info(f"device: {device}; processes: {world}; config: "
                    f"{args.config}")
        seed = args.seed or 0
        img_bb = cfg.model.get("img_backbone") or {}
        pretrained = img_bb.get("pretrained") if img_bb else None
        init_hook = None
        if pretrained:
            from ..apis.pretrain import load_hrnet_pretrained

            def init_hook(state):
                load_hrnet_pretrained(state.model, pretrained, logger=logger)
                return state

        model = build_detector(copy.deepcopy(model_config(cfg)),
                               device=device, seed=seed)
        dataset = build_dataset(cfg.data["train"].to_dict())
        logger.info(f"dataset: {len(dataset)} frames")
        cap = cfg.get("capacity", {})
        batch_size = args.batch_size or cfg.data["samples_per_gpu"]
        loader = SegDataLoader(
            dataset, batch_size=batch_size,
            max_voxels=cap.get("max_voxels", 160000),
            max_points=cap.get("max_points", 140000), shuffle=True,
            seed=seed, num_hosts=world, host_id=rank,
            num_workers=cfg.data.get("workers_per_gpu", 4),
            worker_mode=default_worker_mode(cfg.data),
            ignore_label=cfg.get("ignore_label", 0),
            # a capacity overflow drops rows and changes the gradients
            on_overflow=cfg.get("on_overflow", "error"))
        if args.max_steps_per_epoch:
            loader.sampler = _FirstBatches(loader.sampler,
                                           args.max_steps_per_epoch)
        input_shape = input_shape_of(cfg)
        lr_cfg = dict(cfg.lr_config)
        if args.autoscale_lr:
            scale = cards / 8.0
            lr_cfg["lr_max"] = lr_cfg["lr_max"] * scale
            logger.info(f"autoscale-lr: lr_max *= {scale:.3f} ({cards} "
                        "cards)")
        grad_clip = cfg.optimizer_config.get("grad_clip", {}).get(
            "max_norm", 35.0)

        val_fn, val_loader = None, None
        if args.validate:
            val_dataset = build_dataset(cfg.data["val"].to_dict())
            val_loader = SegDataLoader(
                val_dataset, batch_size=batch_size,
                max_voxels=cap.get("max_voxels", 160000),
                max_points=cap.get("max_points", 140000), shuffle=False,
                num_hosts=world, host_id=rank, num_workers=1,
                drop_last=False)

            def val_fn(state, epoch):
                test_cfg = dict(cfg.get("test_cfg") or {})
                if cfg.model["type"] in DET_TYPES:
                    from ..apis.det_eval import run_det_eval

                    dets = run_det_eval(model, state, val_loader,
                                        input_shape, logger,
                                        test_cfg=test_cfg)
                    logger.info(f"det eval: {len(dets)} frames, "
                                f"{sum(int(d['valid'].sum()) for d in
                                       dets.values())} boxes")
                    return
                dets = run_eval(model, state, val_loader, input_shape,
                                val_dataset, logger, test_cfg=test_cfg)
                evaluate_dataset(val_dataset, dets, logger=logger)

        try:
            state = train_segmentor(
                model=model, loader=loader, input_shape=input_shape,
                optimizer_cfg=dict(cfg.optimizer), lr_cfg=lr_cfg,
                total_epochs=args.total_epochs or cfg.total_epochs,
                work_dir=work_dir, logger=logger, grad_clip=grad_clip,
                log_interval=cfg.get("log_config", {}).get("interval", 5),
                resume_from=args.resume_from, seed=seed, val_fn=val_fn,
                init_hook=init_hook, tb_log_dir=args.tb_log_dir,
                profile_dir=args.profile_dir, hooks=hooks, timings=timings)
        finally:
            loader.shutdown()
            if val_loader is not None:
                val_loader.shutdown()
    finally:
        if log_file is not None:
            logger.removeHandler(log_file)
            log_file.close()
    return {"state": state, "work_dir": work_dir}


if __name__ == "__main__":
    main()
