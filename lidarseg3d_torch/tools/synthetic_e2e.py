"""Synthetic end-to-end mIoU closure (the port's counterpart of
tools/synthetic_e2e.py): train, checkpoint, evaluate and evaluate with
test-time augmentation through the port's own entry points, on a
SemanticKITTI tree whose labels are learnable.

    python -m lidarseg3d_torch.tools.synthetic_e2e [--frames 40]
        [--epochs 20] [--lr 0.01] [--batch_size 2] [--min-miou 0.85]
        [--root DIR] [--device cuda|cpu]

1. ``write_fixture`` writes sequence 00 (velodyne, labels, image_2,
   calib.txt) with the JAX tool's seeded draws: 1400 points a frame in a
   11 x 11 x 3.6 m box, each labelled by its radial ring (2, 3.5 and 5 m)
   and the sign of its z (train classes 1..8, written as their raw
   SemanticKITTI ids); a random 64x128 image a frame, written as PNG by
   ``datasets/pipelines/png.py`` (the port imports no cv2). The label is
   invariant under x/y flips and z-rotations, the test-time augmentation's
   transforms below.
2. ``tools.train`` trains configs/tests/mini_semkitti_mseg3d.py (the
   MSeg3D dataflow: HRNet image branch, fusion, SFFM) over the tree, as
   ``synthetic.write_eval_config`` points it there, with the JAX tool's
   overrides: ``--epochs``, OneCycle to ``--lr``, no geometric train
   augmentation (the label is a function of absolute position), HRNet
   unfrozen as the mini config has it, and a test-time augmentation of
   four variants of rotations and flips only (``tta_cfg``).
3. ``tools.test`` evaluates the last checkpoint on the same frames, then
   again with ``--tta``.
4. It raises unless the mIoU over the present classes is at least
   ``--min-miou`` and the TTA mIoU at least the plain mIoU - 0.02.

The JAX tool's defaults hold, but the device is ``cuda`` unless
``--device cpu`` is given (the JAX tool's default is the CPU), and the
tool raises when there is no card. The closure runs with torch's
deterministic algorithms, so a tree reads the same mIoU in every run on
one card, as the JAX tool's XLA program does on the CPU (without them the
card's reading moved by up to 0.03 between runs). At the default 20
epochs neither this tool nor the JAX package's clears 0.85 (on an H100
this one read 0.6522, TTA 0.6302; the JAX tool 0.6333 / 0.6136 on the
CPU); at ``--epochs 40`` this one clears both checks (0.8848 / 0.8751 on
an H100). The tree and the work dir go under ``--root``, else a new
temporary directory.
"""

import argparse
import os
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MINI_CONFIG = os.path.join(REPO, "configs", "tests", "mini_semkitti_mseg3d.py")
IMH, IMW = 64, 128
TTA_SLACK = 0.02


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Synthetic train -> checkpoint "
                                "-> eval (+ TTA) mIoU closure")
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--frames", type=int, default=40)
    p.add_argument("--root", default=None)
    p.add_argument("--min-miou", type=float, default=0.85)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def write_fixture(root, frames, n=1400, seed=0):
    """Sequence 00 of the learnable tree under ``root`` (module
    docstring): the JAX tool's files at the same seed."""
    from ..datasets.pipelines.png import write_png_bgr
    from ..datasets.semantickitti import metadata as meta

    # one raw id per train class (invert LEARNING_MAP); class 0 is ignored
    inv = {}
    for raw, tr in meta.LEARNING_MAP.items():
        inv.setdefault(tr, raw)
    rng = np.random.default_rng(seed)
    seq = os.path.join(root, "00")
    for d in ("velodyne", "labels", "image_2"):
        os.makedirs(os.path.join(seq, d), exist_ok=True)
    with open(os.path.join(seq, "calib.txt"), "w") as f:
        P = f"500 0 {IMW / 2} 0 0 500 {IMH / 2} 0 0 0 1 0"
        f.write(f"P0: {P}\nP1: {P}\nP2: {P}\nP3: {P}\n")
        f.write("Tr: 0 -1 0 0 0 0 -1 0 1 0 0 0\n")
    for i in range(frames):
        pts = np.stack([
            rng.uniform(-5.5, 5.5, n), rng.uniform(-5.5, 5.5, n),
            rng.uniform(-1.8, 1.8, n), rng.uniform(0, 1, n),
        ], 1).astype(np.float32)
        # radial ring x z-sign -> train classes 1..8
        ring = np.digitize(np.hypot(pts[:, 0], pts[:, 1]), [2.0, 3.5, 5.0])
        train_cls = ring * 2 + (pts[:, 2] > 0).astype(np.int64) + 1
        raw = np.asarray([inv[c] for c in train_cls], np.uint32)
        pts.tofile(os.path.join(seq, "velodyne", f"{i:06d}.bin"))
        (raw | (np.uint32(1) << 16)).tofile(
            os.path.join(seq, "labels", f"{i:06d}.label"))
        img = rng.integers(0, 255, (IMH, IMW, 3), dtype=np.uint8)
        write_png_bgr(os.path.join(seq, "image_2", f"{i:06d}.png"), img)


def write_config(path, fixture, work, epochs, lr):
    """The mini config over ``fixture`` with the closure's overrides
    (module docstring)."""
    from ..synthetic import write_eval_config

    write_eval_config(path, MINI_CONFIG, fixture, work_dir=work)
    with open(path, "a") as f:
        f.write(
            # write_eval_config freezes HRNet's stages as the published
            # configs do; the mini config, and the closure, train them all
            "model['img_backbone']['frozen_stages'] = -1\n"
            f"total_epochs = {epochs}\n"
            f"lr_config = dict(type='one_cycle', lr_max={lr!r},\n"
            "                 moms=[0.95, 0.85], div_factor=10.0,\n"
            "                 pct_start=0.4)\n"
            # the label is a function of absolute position: geometric
            # augmentation would move its boundaries from frame to frame
            "for _st in data['train']['pipeline']:\n"
            "    if _st['type'] == 'SegPreprocess':\n"
            "        _st['cfg'] = dict(_st['cfg'], no_augmentation=True)\n"
            # rotations and flips only: scaling or translation would move
            # the rings' boundaries
            "tta_cfg = dict(num_tta_tranforms=4,\n"
            "               global_rot_noise=[-0.78539816, 0.78539816],\n"
            "               global_scale_noise=[1.0, 1.0],\n"
            "               global_translate_std=0.0)\n")
    return path


def main(argv=None):
    """Run the closure; returns {"miou", "miou_tta" (fractions),
    "seconds": {"fixture", "train", "test", "tta"}, "config": the config
    file it wrote}."""
    import torch

    from ..utils.device import resolve_device

    args = parse_args(argv)
    resolve_device(args.device)  # raises without a card
    # one stream, so cuBLAS is deterministic as it stands; the variable
    # tells torch so
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        return _closure(args)
    finally:
        torch.use_deterministic_algorithms(was)


def _closure(args):
    from . import test as test_tool
    from . import train as train_tool

    root = args.root or tempfile.mkdtemp(prefix="synthetic_e2e_")
    fixture = os.path.join(root, "seqs")
    work = os.path.join(root, "work")
    secs = {}
    t0 = time.perf_counter()
    write_fixture(fixture, args.frames)
    secs["fixture"] = time.perf_counter() - t0
    print(f"fixture: {args.frames} frames at {fixture}", flush=True)
    cfg = write_config(os.path.join(root, "cfg.py"), fixture, work,
                       args.epochs, args.lr)
    dev = ["--device", args.device]

    t0 = time.perf_counter()
    train_tool.main([cfg, "--work_dir", work, "--batch_size",
                     str(args.batch_size)] + dev)
    secs["train"] = time.perf_counter() - t0
    mious = {}
    for key, extra in (("test", []), ("tta", ["--tta"])):
        t0 = time.perf_counter()
        res = test_tool.main([cfg, "--checkpoint", work, "--work_dir",
                              work] + dev + extra)
        secs[key] = time.perf_counter() - t0
        mious[key] = res["results"]["results"]["mIoU"] / 100.0
    miou, miou_tta = mious["test"], mious["tta"]
    print(f"\nEVAL mIoU (full stack, {args.frames} frames, {args.epochs} "
          f"epochs): {miou:.4f}")
    print(f"EVAL mIoU with TTA: {miou_tta:.4f}", flush=True)
    if not miou >= args.min_miou:
        raise RuntimeError(
            f"end-to-end mIoU {miou:.4f} < {args.min_miou}: the train -> "
            "checkpoint -> eval path does not close")
    # the label is invariant under the TTA transforms, so the merged
    # prediction must not degrade
    if not miou_tta >= miou - TTA_SLACK:
        raise RuntimeError(
            f"TTA mIoU {miou_tta:.4f} < plain {miou:.4f} - {TTA_SLACK}: the "
            "TTA merge degrades an invariant-label task")
    print(f"SYNTHETIC E2E CLOSURE: OK (plain {miou:.4f}, tta "
          f"{miou_tta:.4f})", flush=True)
    return {"miou": miou, "miou_tta": miou_tta, "seconds": secs,
            "config": cfg}


if __name__ == "__main__":
    main()
