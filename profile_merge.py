#!/usr/bin/env python3
"""Device time of the merge lookup's kernel, at several sizes, and of its
kept variants, on the semnusc path's KeyTable streams: one process, one
card, every build held exactly against merge_cells_plain.

    python3 profile_merge.py

Builds, with ops/cuda_build.py's nvcc flags, into lidarseg3d_torch/build/:
  - window kK wW: the shipped kernel, lidarseg3d_torch/csrc/merge_lookup.cu
    (a key window per block in shared memory), at K queries a thread and a
    window of W keys (-D MERGE_KPER, MERGE_WINDOW; the package's own build
    is k2 w1024);
  - interleaved: csrc/variants/merge_lookup_interleaved.cu, searches in
    device memory only, two interleaved a thread;
  - bracket: csrc/variants/merge_lookup_bracket.cu, the first port's kernel,
    one search a query.
Streams, as chip_smoke.py phase 4 makes them: the subm query streams of
stages 1 and 2 of a semnusc scan (its model's own structures), stage 1's
stream shuffled, and the subm stream of 131,072 voxels spread over the
92,865,984-cell 0.1 m SemanticKITTI grid. It prints the card, then per
stream and build the device-only ms (chip_smoke.device_ms: the profiler's
summed kernel time a call, the larger of two sessions) in two passes, the
second in reverse build order, and the window builds' tiles by path
(ops/merge_lookup.py PATHS); the last line is one JSON object of it all."""

import ctypes
import hashlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

# label -> (source under csrc/, -D defines, whether it takes the counters)
BUILDS = {
    "window k2 w1024": ("merge_lookup.cu", {}, True),
    "window k2 w2048": ("merge_lookup.cu",
                        {"MERGE_KPER": 2, "MERGE_WINDOW": 2048}, True),
    "window k4 w2048": ("merge_lookup.cu",
                        {"MERGE_KPER": 4, "MERGE_WINDOW": 2048}, True),
    "window k8 w4096": ("merge_lookup.cu",
                        {"MERGE_KPER": 8, "MERGE_WINDOW": 4096}, True),
    "interleaved": ("variants/merge_lookup_interleaved.cu", {}, False),
    "bracket": ("variants/merge_lookup_bracket.cu", {}, False),
}


def build_all():
    """Compile every build in parallel; returns {label: ctypes function}."""
    from lidarseg3d_torch.ops import cuda_build

    out_dir = cuda_build.BUILD / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs, libs = {}, {}
    for label, (src, defs, _) in BUILDS.items():
        path = cuda_build.CSRC / src
        flags = [f"-D{k}={v}" for k, v in sorted(defs.items())]
        digest = hashlib.sha256(path.read_bytes() + " ".join(
            cuda_build.NVCC_FLAGS + flags).encode()).hexdigest()[:16]
        lib = out_dir / f"lib{label.replace(' ', '_')}-{digest}.so"
        libs[label] = lib
        if not lib.exists():
            procs[label] = subprocess.Popen(
                [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, *flags, "-o",
                 str(lib), str(path)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
    for label, proc in procs.items():
        log_text, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"build {label} failed:\n{log_text}")
    fns = {}
    for label, lib in libs.items():
        f = ctypes.CDLL(str(lib)).merge_lookup
        f.restype = ctypes.c_int
        fns[label] = f
    return fns


def streams(cs):
    """{name: (KeyTable, cells)} as chip_smoke.py phase 4 makes them."""
    import torch
    from lidarseg3d_torch import synthetic as syn
    from lidarseg3d_torch.models import build_detector
    from lidarseg3d_torch.ops import coords as co
    from lidarseg3d_torch.ops import sparse as sp

    p = cs.main_paths()["semnusc"]
    gen = torch.Generator().manual_seed(1)
    out = {}
    with torch.inference_mode():
        model = build_detector(syn.mseg3d_model_cfg(**p["cfg"]),
                               device=cs.DEV, seed=0)
        ex = syn.example_to_device(
            syn.synthetic_mseg3d_batch(1, p["V"], p["N"], img_hw=p["img_hw"],
                                       ncam=p["ncam"], seed=0, pcr=p["pcr"],
                                       vsz=p["vsz"]),
            cs.DEV, syn.grid_shape(p["pcr"], p["vsz"]))
        books = model.backbone_mod.structures(
            model.lidar_input(ex).structure)
        for i in (1, 2):
            out[f"nu stage-{i}"] = (books[f"t{i}"], cs.subm_stream(books, i))
        st1 = out["nu stage-1"][1]
        perm = torch.randperm(st1.shape[-1], generator=gen).to(cs.DEV)
        out["nu stage-1 shuffled"] = (books["t1"],
                                      st1[..., perm].contiguous())
        del model, ex, books
        Z, Y, X = cs.BIG_GRID
        V = cs.main_paths()["semkitti"]["V"]
        keys = torch.randperm(Z * Y * X, generator=gen)[:V].sort().values
        big = torch.stack([keys // (Y * X), (keys // X) % Y, keys % X],
                          -1).to(torch.int32)[None].to(cs.DEV)
        nv = torch.tensor([V], dtype=torch.int32, device=cs.DEV)
        kt = co.build_key_table(big, nv, (Z, Y, X))
        sb = sp.build_structure(big, nv, (Z, Y, X))
        out[f"{Z * Y * (X + 2)} cells"] = (kt, cs.subm_stream(
            dict(s1=sb, t1=kt), 1))
    torch.cuda.empty_cache()
    return out


def runner(fn, takes_paths, table, cells, out, paths=None):
    """A callable that launches build ``fn`` on one stream."""
    import torch

    keys, coarse, num = table.keys, table.coarse, table.num
    G, B, V = cells.shape
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    args = [ctypes.c_void_p(keys.data_ptr()), ctypes.c_longlong(keys.shape[1]),
            ctypes.c_void_p(coarse.data_ptr()),
            ctypes.c_longlong(coarse.shape[1] - 1), ctypes.c_int(table.shift),
            ctypes.c_void_p(num.data_ptr()), ctypes.c_void_p(cells.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), ctypes.c_longlong(G),
            ctypes.c_longlong(B), ctypes.c_longlong(V)]
    if takes_paths:
        args.append(ctypes.c_void_p(None if paths is None
                                    else paths.data_ptr()))
    args.append(stream)

    def launch():
        err = fn(*args)
        if err != 0:
            raise RuntimeError(f"launch failed with cudaError_t {err}")
    return launch


def main():
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("profile_merge: no CUDA device\n")
        return 1
    import chip_smoke as cs
    from lidarseg3d_torch.ops.merge_lookup import PATHS, merge_cells_plain

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    cs.log(card)
    t0 = time.perf_counter()
    fns = build_all()
    cs.log(f"built {len(fns)} builds in {time.perf_counter() - t0:.1f} s")
    result = {"card": card, "streams": {}}
    for sname, (table, cells) in streams(cs).items():
        want = merge_cells_plain(table.keys, table.num, cells)
        row = result["streams"][sname] = {"queries": cells.numel(),
                                          "device_ms": {}, "paths": {}}
        runs = {}
        for label, fn in fns.items():
            takes_paths = BUILDS[label][2]
            out = torch.empty_like(cells)
            runs[label] = runner(fn, takes_paths, table, cells, out)
            runs[label]()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise SystemExit(f"{label} differs from merge_cells_plain on "
                                 f"{sname} at {int((out != want).sum())} "
                                 "queries")
            if takes_paths:
                paths = torch.zeros(4, dtype=torch.int64, device=cs.DEV)
                runner(fn, True, table, cells, torch.empty_like(cells),
                       paths)()
                row["paths"][label] = dict(zip(PATHS, paths.tolist()))
        labels = list(fns)
        for label in labels + labels[::-1]:
            row["device_ms"].setdefault(label, []).append(
                cs.device_ms(runs[label]))
        cs.log(f"{sname}: {cells.numel()} queries, exact in every build")
        for label in labels:
            ms = row["device_ms"][label]
            extra = (f"  tiles by path {row['paths'][label]}"
                     if label in row["paths"] else "")
            cs.log(f"  {label:16s} device ms {ms[0]:.4f} / {ms[1]:.4f}"
                   f"{extra}")
    cs.log(json.dumps(result))
    return 0


if __name__ == "__main__":
    t_start = time.time()
    rc = main()
    print(f"profile_merge: {time.time() - t_start:.1f} s", file=sys.stderr)
    sys.exit(rc)
