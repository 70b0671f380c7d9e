#!/usr/bin/env python3
"""chip_smoke.py phase 3c's small train step (ratio 1, small HRNet, no
dropout, one labelled B=2 batch at 64x128) under cuDNN's settings: how
far the card's gradients lie from the CPU's fp32 ones and from the same
step in float64 on the CPU, by group (lidar+head, image), with phase 3c's
limits (chip_smoke.TOL_TRAIN_GRAD), and the time of a step and of an
HRNet-w18 training forward+backward at B=2, 384x1280.

    python3 profile_train_precision.py

Settings, each on the card in turn: cuDNN's defaults, deterministic,
benchmark, cuDNN off (PyTorch's own convolutions), channels-last
parameters and inputs, and (in a process of its own) cuDNN's workspace
capped at 0 MiB (CUDNN_CONV_WSCAP_DBG=0). One card."""
import os
import subprocess
import sys
import tempfile
import time

import torch

import chip_smoke as cs


def grads(dev, dt, variant):
    from lidarseg3d_torch import synthetic as syn
    from lidarseg3d_torch.apis import train as tr
    from lidarseg3d_torch.models import build_detector

    cfg = syn.mseg3d_model_cfg(ratio=1, small_hrnet=True)
    cfg["point_head"]["model_cfg"]["DP_RATIO"] = 0
    b = syn.synthetic_mseg3d_batch(2, 4096, 4096, img_hw=(64, 128), seed=7,
                                   with_labels=True)
    m = build_detector(cfg, device=dev, seed=3).to(dt)
    if variant == "channels_last":
        m = m.to(memory_format=torch.channels_last)
    _, state, step = cs.train_setup(
        m, dict(type="adam", wd=0.01), dict(lr_max=2e-3), 12, 35.0,
        syn.grid_shape())
    ex = {k: v.to(dt) if v.is_floating_point() else v
          for k, v in tr.example_to_device(b, dev).items()}
    state, ldict = step(state, ex)
    losses = cs.check_losses(ldict, f"{variant} {dev}")
    g = {k: p.grad.detach().double().cpu() for k, p in m.named_parameters()}
    t = None
    if dev != "cpu":
        torch.cuda.synchronize()
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            state, ldict = step(state, ex)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        t = min(ts)
    return losses, g, t


def hrnet_time(variant):
    from lidarseg3d_torch import synthetic as syn
    from lidarseg3d_torch.models import build_img_backbone

    m = build_img_backbone(syn.mseg3d_model_cfg()["img_backbone"]).to(cs.DEV)
    x = torch.randn(2, 3, 384, 1280, device=cs.DEV)
    if variant == "channels_last":
        m = m.to(memory_format=torch.channels_last)
        x = x.contiguous(memory_format=torch.channels_last)
    ts = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = m.train()(x)
        sum(o.float().mean() for o in outs).backward()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return min(ts[1:])


def set_variant(v):
    c = torch.backends.cudnn
    c.enabled, c.deterministic, c.benchmark = True, False, False
    if v == "deterministic":
        c.deterministic = True
    elif v == "benchmark":
        c.benchmark = True
    elif v == "nocudnn":
        c.enabled = False


def compare(name, card, cpu, ref):
    out = []
    for side, g in (("card", card[1]), ("cpu", cpu[1])):
        for group in ("lidar+head", "image"):
            wl2 = ("", 0.0)
            for k, want in ref.items():
                if ("image" if k.startswith("img_") else "lidar+head") != group:
                    continue
                if float(want.abs().max()) <= 1e-7 * cpu[0]["grad_norm"]:
                    continue
                d = float((g[k] - want).norm() / want.norm())
                wl2 = max(wl2, (k, d), key=lambda kv: kv[1])
            out.append(f"{side} vs f64 {group} {wl2[1]:.3e} ({wl2[0]})")
    floor = 1e-8 * cpu[0]["grad_norm"]
    bad = []
    worst = {}
    for k, want in cpu[1].items():
        group = "image" if k.startswith("img_") else "lidar+head"
        tl2, tmax = cs.TOL_TRAIN_GRAD[group]
        scale = float(want.abs().max())
        err = float((card[1][k] - want).abs().max())
        if err > tmax * scale + floor:
            bad.append(k)
        if scale <= 10 * floor:
            continue
        l2 = float((card[1][k] - want).norm() / want.norm())
        if l2 > tl2:
            bad.append(k)
        worst[group] = max(worst.get(group, ("", 0.0)), (k, l2),
                           key=lambda kv: kv[1])
    loss = max(abs(card[0][k] - v) / abs(v) for k, v in cpu[0].items())
    print(f"== {name}: card-vs-CPU worst L2 " + ", ".join(
        f"{g} {v[1]:.3e} ({v[0]})" for g, v in worst.items())
        + f"; loss rel {loss:.2e}; step {card[2]:.1f} ms; "
        + ("PASS" if not bad else f"FAIL {sorted(set(bad))[:4]}"), flush=True)
    for line in out:
        print("   ", line, flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_train_precision.py needs a CUDA card")
    if len(sys.argv) > 2 and sys.argv[1] == "card":
        v = sys.argv[2]
        set_variant(v)
        torch.save(grads(cs.DEV, torch.float32, v), sys.argv[3])
        return
    from lidarseg3d_torch.ops import cuda_build

    cuda_build.build()
    cpu = grads("cpu", torch.float32, "cpu")
    ref = grads("cpu", torch.float64, "cpu")[1]
    for v in ("default", "deterministic", "benchmark", "nocudnn",
              "channels_last"):
        set_variant(v)
        compare(v, grads(cs.DEV, torch.float32, v), cpu, ref)
        print(f"   HRNet-w18 B=2 384x1280 train fwd+bwd {hrnet_time(v):.1f} ms",
              flush=True)
    set_variant("default")
    for v, env in (("wscap0", {"CUDNN_CONV_WSCAP_DBG": "0"}),):
        f = os.path.join(tempfile.mkdtemp(), f"{v}.pt")
        subprocess.run([sys.executable, __file__, "card", "default", f],
                       env=dict(os.environ, **env), check=True)
        compare(v, torch.load(f, weights_only=False), cpu, ref)


if __name__ == "__main__":
    main()
