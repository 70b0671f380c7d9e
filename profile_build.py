#!/usr/bin/env python3
"""Time of the structures+rulebooks build of one scan on the port's two
inference paths, for comparing two trees of the port in one call on one
card.

    python3 profile_build.py [ROOT]

ROOT (default: this checkout) is the tree whose ``lidarseg3d_torch`` is
imported and whose kernels are built; the measuring code is this file's and
chip_smoke.py's, so an older tree is measured the same way as this one.
For semkitti and semnusc at chip_smoke.py's shapes (seeded random weights,
three distinct synthetic scans) it times UNetSCN3D.structures (stage
structures, lookup tables and the 10 rulebooks): CUDA events around each of
30 builds after a warm round (the span from the first launch to the end of
the last kernel; the build is host-bound, so this is the host's pace), the
host's own time per build without synchronising inside the loop, and one
profiled build (chip_smoke.profile_call: device kernels, busy share). It
prints the card's name and power limit first; the last line is one JSON
object of it all. Compare two trees in turns (A, B,
B, A): one call, one card."""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BUILDS = 30


def main():
    root = os.path.abspath(sys.argv[1]) if len(sys.argv) > 1 else HERE
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("profile_build: no CUDA device\n")
        return 1
    import importlib.util

    import lidarseg3d_torch
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_main", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from lidarseg3d_torch import synthetic as syn
    from lidarseg3d_torch.models import build_detector
    from lidarseg3d_torch.ops import cuda_build

    log = cs.log
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"card {card}")
    log(f"tree {os.path.dirname(os.path.dirname(lidarseg3d_torch.__file__))}"
        f"; built in {cuda_build.build():.1f} s")
    out = {"root": root, "card": card}
    for name, p in cs.main_paths().items():
        model = build_detector(syn.mseg3d_model_cfg(**p["cfg"]),
                               device=cs.DEV, seed=0)
        ishape = syn.grid_shape(p["pcr"], p["vsz"])
        with torch.inference_mode():
            sts = [model.lidar_input(syn.example_to_device(
                syn.synthetic_mseg3d_batch(1, p["V"], p["N"],
                                           img_hw=p["img_hw"], ncam=p["ncam"],
                                           seed=s, pcr=p["pcr"],
                                           vsz=p["vsz"]), cs.DEV, ishape))
                   .structure for s in range(3)]
            build = model.backbone_mod.structures
            for st in sts:
                build(st)
            torch.cuda.synchronize()
            spans = []
            for i in range(BUILDS):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                build(sts[i % 3])
                b.record()
                torch.cuda.synchronize()
                spans.append(a.elapsed_time(b))
            t0 = time.perf_counter()
            for i in range(BUILDS):
                build(sts[i % 3])
            host = (time.perf_counter() - t0) / BUILDS * 1e3
            torch.cuda.synchronize()
            log(f"{name}:")
            share, per_name = cs.profile_call(lambda: build(sts[0]),
                                              "structures+rulebooks build")
        spans.sort()
        out[name] = dict(
            span_ms_mean=sum(spans) / len(spans),
            span_ms_p50=spans[len(spans) // 2], host_ms=host,
            kernels=sum(c for _, c in per_name.values()),
            device_ms=sum(us for us, _ in per_name.values()) / 1e3,
            device_busy_share=share)
        log(f"  {name} build: span mean {out[name]['span_ms_mean']:.3f} ms, "
            f"p50 {out[name]['span_ms_p50']:.3f} ms, host "
            f"{host:.3f} ms a build, {out[name]['kernels']} kernels, device "
            f"{out[name]['device_ms']:.3f} ms")
        del model, sts
        torch.cuda.empty_cache()
    log(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
