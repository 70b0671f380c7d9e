#!/usr/bin/env python3
"""Device time of the port's kernels on its main paths, for comparing two
trees of the port in one call on one card.

    python3 profile_convs.py [ROOT]

ROOT (default: this checkout) is the tree whose ``lidarseg3d_torch`` is
imported and whose kernels are built; the measuring code is this file's and
chip_smoke.py's, so an older tree is measured the same way as this one.
It builds the kernels, takes the semkitti training step of chip_smoke.py
phase 3c (fp32, B=2; one warm step, one counted step whose launches must be
chip_smoke.py's TRAIN per_step: 71 conv / 36 dW / 10 fused rulebook
builds / 1 own-cell lookup and 4 packs, one per table; the tree needs
the wrappers chip_smoke.wrappers names) and
profiles one more step, then profiles one semkitti scan and one semnusc
scan (each after a warm one), and prints each profile's busy time, the summed device time and
launches of every conv / dW kernel name, and the sums of the rank-table
pack, lookup and merge kernels; the last line is one JSON object with
those sums and each profile's summed device time. Compare two trees in
turns (A, B, B, A): one call, one card."""

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
# kernel names of the table kernels in a profile, this tree's and older
# trees' (the pack was three kernels before it was one; a rulebook was one
# gather_cells among plain operations before the fused rulebook kernels)
TABLE_KERNELS = {"pack": ("rank_pack_kernel", "block_counts", "scan_blocks",
                          "pack_write"),
                 "lookup": ("gather_cells", "rulebook_kernel",
                            "single_kernel"),
                 "merge": ("merge_lookup_kernel",)}


def table_kernel_sums(log, per_name):
    """{pack, lookup, merge: [device ms, kernels]} of one profile."""
    import re

    out = {}
    for group, names in TABLE_KERNELS.items():
        pat = re.compile(r"\(anonymous namespace\)::(%s)\b"
                         % "|".join(names))
        hits = [(us, cnt) for name, (us, cnt) in per_name.items()
                if pat.search(name)]
        out[group] = [sum(us for us, _ in hits) / 1e3,
                      sum(c for _, c in hits)]
    log("    table kernels: " + ", ".join(
        f"{g} {ms:.4f} ms x{c}" for g, (ms, c) in out.items()))
    return out


def main():
    root = os.path.abspath(sys.argv[1]) if len(sys.argv) > 1 else HERE
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("profile_convs: no CUDA device\n")
        return 1
    # the tree's package first (chip_smoke puts its own directory in
    # front); this file's chip_smoke by path (ROOT may hold its own)
    import importlib.util

    import lidarseg3d_torch
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_main", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from lidarseg3d_torch import synthetic as syn
    from lidarseg3d_torch.apis import train as tr
    from lidarseg3d_torch.models import build_detector
    from lidarseg3d_torch.ops import cuda_build

    log = cs.log
    log(f"tree {os.path.dirname(os.path.dirname(lidarseg3d_torch.__file__))}"
        f"; built in {cuda_build.build():.1f} s")
    t = cs.TRAIN
    out = {"root": root}

    # the training step at chip_smoke.py phase 3c's shape
    model = build_detector(syn.mseg3d_model_cfg(**t["cfg"]), device=cs.DEV,
                           seed=0)
    exs = [tr.example_to_device(
        syn.synthetic_mseg3d_batch(t["B"], t["V"], t["N"], img_hw=t["img_hw"],
                                   seed=100 + s, with_labels=True), cs.DEV)
        for s in range(3)]
    _, state, step = cs.train_setup(model, t["optimizer"], t["lr"],
                                    t["total_steps"], t["grad_clip"],
                                    syn.grid_shape())
    state, _ = step(state, exs[0])
    ws = cs.wrappers()
    for w in ws.values():
        w.launches = 0
    state, _ = step(state, exs[1])
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in ws.items()}
    want = dict(t["per_step"])
    if launches != want:
        raise SystemExit(f"train step launches {launches}, expected {want}")
    log(f"train step launches: {launches}")
    log("train step:")
    share, per_name = cs.profile_call(lambda: step(state, exs[2]),
                                      "train step")
    out["train"] = cs.conv_kernel_sums(per_name)
    out["train"]["tables"] = table_kernel_sums(log, per_name)
    out["train"]["device_ms"] = sum(us for us, _ in per_name.values()) / 1e3
    del model, exs, state, step
    torch.cuda.empty_cache()

    # one scan of each inference path
    for name, p in cs.main_paths().items():
        model = build_detector(syn.mseg3d_model_cfg(**p["cfg"]),
                               device=cs.DEV, seed=0)
        ex = syn.example_to_device(
            syn.synthetic_mseg3d_batch(1, p["V"], p["N"], img_hw=p["img_hw"],
                                       ncam=p["ncam"], seed=0, pcr=p["pcr"],
                                       vsz=p["vsz"]),
            cs.DEV, syn.grid_shape(p["pcr"], p["vsz"]))

        def scan():
            ret, bat = model(ex)
            model.predict(ret, bat)

        scan()
        torch.cuda.synchronize()
        log(f"{name} scan:")
        share, per_name = cs.profile_call(scan, "scan")
        out[name] = cs.conv_kernel_sums(per_name)
        out[name]["tables"] = table_kernel_sums(log, per_name)
        out[name]["device_ms"] = sum(us for us, _ in per_name.values()) / 1e3
        del model, ex
        torch.cuda.empty_cache()
    log(json.dumps(out))
    return 0


if __name__ == "__main__":
    t0 = time.time()
    rc = main()
    print(f"profile_convs: {time.time() - t0:.1f} s", file=sys.stderr)
    sys.exit(rc)
