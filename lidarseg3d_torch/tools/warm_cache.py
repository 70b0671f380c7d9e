"""Pre-flight a config on the card (the port's counterpart of
tools/warm_cache.py): build the kernels, then run one train step and one
eval step on a synthetic batch of the config's shapes, and print the
seconds and the peak device memory of each.

    python -m lidarseg3d_torch.tools.warm_cache CONFIG [--batch_size N]
        [--eval_only | --train_only] [--max_voxels N] [--max_points N]
        [--device cuda|cpu]

On the CPU the host C helpers are built and the kernels' plain versions
run. The batch comes from the config alone, as the JAX tool's does: its
capacities (``--max_voxels`` / ``--max_points`` override them), its
voxel generator's range and voxel size, and for a config with an image
branch its ``img_resized_shape`` and ``cam_names``
(``synthetic_example``: the seeded ground-plane scans of
``lidarseg3d_torch.synthetic``, collated as the loader collates). B is
``--batch_size``, else the config's ``samples_per_gpu``. The train step is
``apis.train.make_train_step`` with the config's optimizer (OneCycle over
1000 steps), the eval step ``make_eval_step`` on the state it left; so the
tool shows, before a launch, whether the config's batch fits the card.
Segmentation configs with a host voxel generator (MSeg3D, SegNet) run; a
SegPolarNet config has none, and the JAX tool refuses it too (ROADMAP §C,
reference fault 10); a detection config's synthetic batch has 4 point
features where its reader takes 5 or 6, and no box targets, so it is
refused, where the JAX tool fails (its reader asserts the width, its loss
reads ``det_targets``). The device is ``cuda`` unless
``--device cpu`` is given, and the tool raises when there is no card.

What does not carry over from the JAX tool: PyTorch has no lower/compile
split, so each step always runs (the JAX tool's ``--execute``); the only
cache that outlives the process is the kernels' build in
``lidarseg3d_torch/build/``, so there is no ``--cache_dir`` or
``--host_device_count``; cuDNN's algorithm choices and the allocator's
pools stay warm only for a caller that runs ``main(argv)`` in its own
process before its real work.
"""

import argparse
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Build the kernels and run one "
                                "train and one eval step of a config")
    p.add_argument("config", help="config file path")
    p.add_argument("--batch_size", default=None, type=int)
    p.add_argument("--eval_only", action="store_true",
                   help="run only the eval step")
    p.add_argument("--train_only", action="store_true",
                   help="run only the train step")
    p.add_argument("--max_voxels", default=None, type=int,
                   help="override the config's capacity")
    p.add_argument("--max_points", default=None, type=int)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def synthetic_example(cfg, batch_size, max_voxels=None, max_points=None):
    """A collated batch at the config's padded capacities, derived from the
    config alone (the JAX tool's ``synthetic_example``, through this
    package's copies of its synthetic builders). A config without a
    ``voxel_generator`` raises ValueError."""
    from ..synthetic import synthetic_batch, synthetic_mseg3d_batch

    if "voxel_generator" not in cfg:
        raise ValueError(
            "the config has no voxel_generator: its model voxelizes the "
            "points on the device (SegPolarNet), so no voxel batch derives "
            "from it (the JAX tool fails on it too: ROADMAP §C, reference "
            "fault 10)")
    cap = cfg.get("capacity", {})
    V = int(max_voxels or cap.get("max_voxels", 160000))
    N = int(max_points or cap.get("max_points", 140000))
    pcr = list(cfg.voxel_generator["range"])
    vsz = list(cfg.voxel_generator["voxel_size"])
    if cfg.model.get("img_backbone"):
        W, H = cfg.img_resized_shape
        ncam = len(cfg.get("cam_names", ["1"]))
        batch = synthetic_mseg3d_batch(batch_size, V, N, img_hw=(H, W),
                                       ncam=ncam, with_labels=True, pcr=pcr,
                                       vsz=vsz)
    else:
        batch = synthetic_batch(batch_size, V, N, with_labels=True, pcr=pcr,
                                vsz=vsz)
    return {k: v for k, v in batch.items() if k != "metadata"}


def _timed(fn, device):
    """fn() -> (its result, seconds to a synchronisation, peak bytes of
    device memory or None on the CPU)."""
    import torch

    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    out = fn()
    if on_card:
        torch.cuda.synchronize(device)
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if on_card else None
    return out, secs, peak


def _report(what, secs, peak):
    mem = ("not measured (cpu)" if peak is None
           else f"{peak / 2 ** 30:.2f} GiB")
    print(f"{what} ran in {secs:.2f} s; peak device memory {mem}",
          flush=True)


def main(argv=None):
    """Run the tool; returns {"build_seconds", "batch_size", "train" and
    "eval": {"seconds", "peak_bytes"} of the steps that ran, "state": the
    train state the steps ran on}."""
    from ..apis.train import (create_train_state, example_to_device,
                              make_eval_step, make_train_step)
    from ..models import build_detector
    from ..ops import cuda_build
    from ..solver.optim import build_one_cycle_optimizer
    from ..utils.config import Config
    from ..utils.device import resolve_device
    from .test import DET_TYPES, input_shape_of, model_config

    args = parse_args(argv)
    device = resolve_device(args.device)  # raises without a card
    cfg = Config.fromfile(args.config)
    if cfg.model["type"] in DET_TYPES:
        raise ValueError(f"{cfg.model['type']}: a detection config's "
                         "synthetic batch carries 4 point features and no "
                         "box targets, so neither step can run (the JAX "
                         "tool's reader asserts the config's width and its "
                         "loss reads det_targets); the tool runs "
                         "segmentation configs")
    B = args.batch_size or cfg.data["samples_per_gpu"]
    ex = synthetic_example(cfg, B, args.max_voxels, args.max_points)
    out = {"batch_size": B, "build_seconds": 0.0}
    # the CUDA kernels and the host C helpers; on the CPU, where the
    # kernels' plain versions run, the host C helpers alone
    names = None if device.type == "cuda" else list(cuda_build.HOST_SOURCES)
    out["build_seconds"] = cuda_build.build(names)
    print(f"{'kernels and ' if names is None else ''}host C helpers built "
          f"in {out['build_seconds']:.1f} s", flush=True)
    input_shape = input_shape_of(cfg)
    model = build_detector(model_config(cfg), device=device, seed=0)
    grad_clip = cfg.optimizer_config.get("grad_clip", {}).get("max_norm",
                                                              35.0)
    tx, _ = build_one_cycle_optimizer(dict(cfg.optimizer),
                                      dict(cfg.lr_config), total_steps=1000,
                                      grad_clip=grad_clip)
    state = create_train_state(model, tx)
    batch = example_to_device(ex, device)
    print(f"batch: B={B}, voxels {tuple(ex['voxels'].shape)}, points "
          f"{tuple(ex['points'].shape)}, grid {input_shape}", flush=True)

    if not args.eval_only:
        step = make_train_step(model, tx, input_shape)
        (state, ldict), secs, peak = _timed(lambda: step(state, batch),
                                            device)
        _report("train step", secs, peak)
        out["train"] = {"seconds": secs, "peak_bytes": peak,
                        "loss": float(ldict["loss"])}
    if not args.train_only:
        estep = make_eval_step(model, input_shape)
        _, secs, peak = _timed(lambda: estep(state, batch), device)
        _report("eval step", secs, peak)
        out["eval"] = {"seconds": secs, "peak_bytes": peak}
    out["state"] = state
    return out


if __name__ == "__main__":
    main()
