#!/usr/bin/env python3
"""Drive the port's main path on one CUDA card and hold its kernels against
their plain PyTorch versions.

    python3 chip_smoke.py

Phases (each fails loudly with a non-zero exit):
  1. print the card's name and power limit (nvidia-smi); no card -> exit 1;
  2. build the CUDA kernels from lidarseg3d_torch/csrc into
     lidarseg3d_torch/build (one nvcc per source, in parallel);
  3. run the SemanticKITTI MSeg3D inference forward (UNetSCN3D r=2,
     HRNet-w18, fusion head; seeded random weights) on three distinct
     synthetic scans (V=131072, N=122880, one 384x1280 camera) through
     build_detector / forward / predict, check the outputs and that every
     kernel's launch count rose by its per-forward count; compare a small
     model on the card with the same model on the CPU (plain versions);
     time scans and the branch split;
  4. hold each kernel against its plain version on the card at the main
     path's shapes (rulebooks taken from a real synthetic scan at
     V=131072): the rulebook conv in fp32 and bf16, the rank-table lookup
     and pack exactly, on the 1,387,008-cell stage-1 table and on a
     92,865,984-cell table (41x1504x1506, the 0.1 m SemanticKITTI grid);
     times are CUDA-event means of back-to-back calls after warm-up, and
     device-only means (the profiler's summed kernel durations);
  5. profile one scan (device busy share and the kernels that take the
     time); print the card line, one JSON line of the kernels, then the
     result line.
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

V, N, IMG_HW = 131072, 122880, (384, 1280)
NSCANS = 3
PER_FORWARD = {"rulebook_conv": 36, "rank_lookup": 11, "rank_pack": 4}
# H100 SXM published peaks (NVIDIA's data sheet, dense, at 700 W): HBM
# bytes/s and FLOP/s per input type
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"fp32": 67e12, "bf16": 989e12}
TOL_CONV = {"fp32": 1e-5, "bf16": 2.0 ** -7}  # max |err| / max |plain|


def log(*a):
    print(*a, flush=True)


def cuda_time(fn, reps=20, warmup=3):
    """Mean milliseconds of fn() over ``reps`` launches (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps=10):
    """Mean device milliseconds per fn() call: the summed durations of the
    device activities fn starts (torch.profiler), without the host-side
    gaps between launches that ``cuda_time`` also counts."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kern:
        raise SystemExit("profiler recorded no device activity")
    return sum(e.time_range.end - e.time_range.start
               for e in kern) / reps / 1e3


def timings(fn, plain, library=None, plain_reps=20):
    """The timing keys of a kernel row: CUDA-event means (``ms``,
    ``plain_ms``, ``library_ms``) and device-only means (``device_ms``,
    ``plain_device_ms``, ``library_device_ms``)."""
    t = dict(ms=cuda_time(fn), plain_ms=cuda_time(plain, reps=plain_reps),
             library_ms=None if library is None else cuda_time(library),
             device_ms=device_ms(fn), plain_device_ms=device_ms(plain),
             library_device_ms=None)
    if library is not None:
        t["library_device_ms"] = device_ms(library)
    return t


def fmt_times(row):
    lib = ("" if row["library_ms"] is None else
           f" library_ms={row['library_ms']:.4f} "
           f"(device {row['library_device_ms']:.4f})")
    return (f"ms={row['ms']:.4f} (device {row['device_ms']:.4f}) "
            f"plain_ms={row['plain_ms']:.4f} (device "
            f"{row['plain_device_ms']:.4f}){lib} "
            f"bound_ms={row['bound_ms']:.4f}")


def check_conv(report, name, feats, rb, cin, cout, gen):
    import torch
    from lidarseg3d_torch.ops import sparse as sp
    from lidarseg3d_torch.ops.rulebook_conv import (rulebook_conv,
                                                    rulebook_conv_plain)

    K = rb.shape[0]
    w32 = (torch.rand(K, cin, cout, generator=gen) * 2 - 1).cuda() \
        / (K * cin) ** 0.5
    miss = feats.shape[0] * feats.shape[1]
    hit = rb != miss
    pairs = int(hit.sum())
    # feature rows the function must read: the distinct partner rows plus
    # the zero row of misses (capacity rows no entry names are never read)
    rows = int(torch.unique(rb[hit]).numel()) + 1
    for dt, torch_dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        ff = sp.flat_features(feats.to(torch_dt))
        w = w32.to(torch_dt).contiguous()
        got = rulebook_conv(ff, rb, w).float()
        want = rulebook_conv_plain(ff, rb, w).float()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        scale = max(float(want.abs().max()), 1e-30)
        ok = err <= TOL_CONV[dt] * scale
        es = 4 if dt == "fp32" else 2
        nbytes = (rows * cin * es + rb.numel() * 4 + w.numel() * es
                  + rb.shape[1] * rb.shape[2] * cout * es)
        flops = 2.0 * pairs * cin * cout
        t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dt]
        row = dict(
            name=f"rulebook_conv[{name} {cin}->{cout} {dt}]", route="cuda",
            source="lidarseg3d_torch/csrc/rulebook_conv.cu",
            replaces="lidarseg3d_tpu/ops/pallas_conv.py:215",
            launches=None, max_abs_err=err,
            bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            **timings(lambda: rulebook_conv(ff, rb, w),
                      lambda: rulebook_conv_plain(ff, rb, w), plain_reps=5))
        log(f"  conv {name} {cin}->{cout} {dt}: M={rb.shape[1]*rb.shape[2]} "
            f"pairs={pairs} rows read={rows} max_abs_err={err:.3e} "
            f"(max|plain|={scale:.3e}, tol {TOL_CONV[dt]:.1e} rel) "
            f"{fmt_times(row)}")
        if not ok:
            raise SystemExit(f"rulebook_conv {name} {dt} disagrees with its "
                             f"plain version: {err} > {TOL_CONV[dt]}*{scale}")
        report.append(row)


def check_lookup(report, name, packed, cells):
    import torch
    from lidarseg3d_torch.ops.rank_lookup import (gather_cells,
                                                  gather_cells_plain)

    got = gather_cells(packed, cells)
    want = gather_cells_plain(packed, cells)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise SystemExit(f"rank_lookup {name} differs from its plain version "
                         f"at {int((got != want).sum())} queries")
    q = cells.numel()
    touched = int(torch.unique(cells).numel())
    flat = packed.reshape(-1)
    idx = cells.reshape(-1).to(torch.int64)  # B == 1: flat index == cell
    row = dict(
        name=f"rank_lookup[{name}]", route="cuda",
        source="lidarseg3d_torch/csrc/rank_lookup.cu",
        replaces=("lidarseg3d_tpu/ops/pallas_lookup.py:104"
                  if packed.shape[1] * 4 > 12 * 2**20
                  else "lidarseg3d_tpu/ops/pallas_lookup.py:69"),
        launches=None, max_abs_err=0.0,
        bound_ms=(8.0 * q + 4.0 * touched) / PEAK_BYTES * 1e3,
        bound_by="bytes",
        **timings(lambda: gather_cells(packed, cells),
                lambda: gather_cells_plain(packed, cells),
                lambda: torch.take(flat, idx)))
    log(f"  lookup {name}: nce={packed.shape[1]} queries={q} exact "
        f"{fmt_times(row)}")
    report.append(row)


def check_pack(report, name, act):
    import torch
    from lidarseg3d_torch.ops.rank_pack import (pack_rank_table,
                                                pack_rank_table_plain)

    got = pack_rank_table(act)
    want = pack_rank_table_plain(act)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise SystemExit(f"rank_pack {name} differs from its plain version "
                         f"at {int((got != want).sum())} cells")
    nce = act.numel()
    row = dict(
        name=f"rank_pack[{name}]", route="cuda",
        source="lidarseg3d_torch/csrc/rank_pack.cu",
        replaces="lidarseg3d_tpu/ops/pallas_rank.py:48",
        launches=None, max_abs_err=0.0,
        bound_ms=5.0 * nce / PEAK_BYTES * 1e3, bound_by="bytes",
        **timings(lambda: pack_rank_table(act),
                lambda: pack_rank_table_plain(act)))
    log(f"  pack {name}: nce={nce} active={int(act.sum())} exact "
        f"{fmt_times(row)}")
    report.append(row)


def kernel_checks(model, ex):
    """Phase 4: every kernel against its plain version at the main path's
    shapes. Returns the report rows."""
    import torch
    from lidarseg3d_torch.ops import coords as co
    from lidarseg3d_torch.ops import sparse as sp
    from lidarseg3d_torch.ops.rank_pack import pack_rank_table_plain

    report = []
    gen = torch.Generator().manual_seed(1)
    with torch.inference_mode():
        st = model.lidar_input(ex)
        books = model.backbone_mod.structures(st.structure)
        s1, s4 = books["s1"], books["s4"]
        log(f"  stage voxels: s1={int(s1.num_voxels[0])}/{s1.capacity} "
            f"s2={int(books['s2'].num_voxels[0])} "
            f"s3={int(books['s3'].num_voxels[0])} "
            f"s4={int(s4.num_voxels[0])}/{s4.capacity}")

        # conv at its main-path shapes
        check_conv(report, "subm V=131072", st.features, books["subm1"], 12,
                   32, gen)
        f2 = torch.rand(1, s1.capacity, 32, generator=gen).cuda()
        check_conv(report, "strided 131072->65536", f2, books["down2"], 32,
                   64, gen)
        f4 = torch.rand(1, s4.capacity, 256, generator=gen).cuda()
        check_conv(report, f"subm V={s4.capacity}", f4, books["subm4"], 256,
                   128, gen)

        # lookup + pack on the stage-1 table of this scan
        act1 = co.activity(s1.coords, s1.num_voxels, s1.spatial_shape)
        check_pack(report, "stage-1 1387008 cells",
                   act1[0, :act1.shape[1] - 1])
        cells, _ = sp.rank3_query_cells(books["t1"], *sp.subm_queries(s1))
        check_lookup(report, "stage-1 1387008 cells",
                     books["t1"].packed, cells.contiguous())

        # the 0.1 m SemanticKITTI grid: 41 x 1504 x (1504 + 2) cells, with
        # the scan's voxels spread over it key-sorted
        Z, Y, X = 41, 1504, 1504
        nce = Z * Y * (X + 2)
        keys = torch.randperm(Z * Y * X, generator=gen)[:V].sort().values
        big = torch.stack([keys // (Y * X), (keys // X) % Y, keys % X],
                          -1).to(torch.int32)[None].cuda()
        nv = torch.tensor([V], dtype=torch.int32, device="cuda")
        actb = co.activity(big, nv, (Z, Y, X))
        check_pack(report, f"{nce} cells", actb[0, :nce])
        sb = sp.build_structure(big, nv, (Z, Y, X))
        tb = co.RankTable(packed=pack_rank_table_plain(actb[0, :nce])[None],
                          spatial_shape=(Z, Y, X))
        cells, _ = sp.rank3_query_cells(tb, *sp.subm_queries(sb))
        check_lookup(report, f"{nce} cells", tb.packed, cells.contiguous())
        del actb, tb, cells
    torch.cuda.empty_cache()
    return report


def check_outputs(ret, pred, ncls):
    import torch

    logits = ret["out_logits"]
    labels = pred["pred_point_sem_labels"]
    if tuple(logits.shape) != (1, N, ncls) or not torch.isfinite(logits).all():
        raise SystemExit(f"bad logits: shape {tuple(logits.shape)}, finite "
                         f"{bool(torch.isfinite(logits).all())}")
    if tuple(labels.shape) != (1, N) or int(labels.min()) < 0 \
            or int(labels.max()) >= ncls:
        raise SystemExit(f"bad labels: shape {tuple(labels.shape)}, range "
                         f"[{int(labels.min())}, {int(labels.max())}]")
    for k in ("voxel_logits", "point_features_camera",
              "point_features_pcamera"):
        if not torch.isfinite(ret[k]).all():
            raise SystemExit(f"non-finite {k}")


def small_agreement():
    """The same small seeded model on the card and on the CPU (plain
    versions of every kernel): logits and labels must agree."""
    import torch
    from lidarseg3d_torch import synthetic as syn
    from lidarseg3d_torch.models import build_detector

    cfg = syn.mseg3d_model_cfg(ratio=1, small_hrnet=True)
    b = syn.synthetic_mseg3d_batch(1, 4096, 4096, img_hw=(64, 128), seed=7)
    out = {}
    for dev in ("cuda", "cpu"):
        m = build_detector(cfg, device=dev, seed=3)
        ex = syn.example_to_device(b, dev, syn.grid_shape())
        ret, bat = m(ex)
        out[dev] = (ret["out_logits"].float().cpu(),
                    m.predict(ret, bat)["pred_point_sem_labels"].cpu())
    err = float((out["cuda"][0] - out["cpu"][0]).abs().max())
    agree = float((out["cuda"][1] == out["cpu"][1]).float().mean())
    log(f"  small model card vs CPU: max_abs_err(logits)={err:.3e} "
        f"labels agree {agree:.6f}")
    if err > 1e-3 or agree < 0.999:
        raise SystemExit("the small model on the card disagrees with the CPU")


def main_path():
    """Phase 3: the counted run over the distinct scans, then timing.
    Returns (result, launches per kernel over the run, model, one example).
    It runs before any profiler session: an initialised profiler adds host
    time to every launch."""
    import torch
    from lidarseg3d_torch import synthetic as syn
    from lidarseg3d_torch.models import build_detector
    from lidarseg3d_torch.ops.rank_lookup import gather_cells
    from lidarseg3d_torch.ops.rank_pack import pack_rank_table
    from lidarseg3d_torch.ops.rulebook_conv import rulebook_conv

    wrappers = {"rulebook_conv": rulebook_conv, "rank_lookup": gather_cells,
                "rank_pack": pack_rank_table}
    ishape = syn.grid_shape()
    cfg = syn.mseg3d_model_cfg(ratio=2)
    model = build_detector(cfg, seed=0)
    t0 = time.perf_counter()
    batches = [syn.synthetic_mseg3d_batch(1, V, N, img_hw=IMG_HW, seed=s)
               for s in range(NSCANS)]
    log(f"  host: {NSCANS} scans voxelized in "
        f"{time.perf_counter() - t0:.2f} s; voxels "
        f"{[int(b['num_voxels'][0]) for b in batches]}")
    coords = [b["coordinates"] for b in batches]
    if any((coords[i] == coords[j]).all() for i in range(NSCANS)
           for j in range(i)):
        raise SystemExit("synthetic scans share a coordinate set")
    exs = [syn.example_to_device(b, "cuda", ishape) for b in batches]

    small_agreement()

    for w in wrappers.values():
        w.launches = 0
    for ex in exs:
        ret, bat = model(ex)
        check_outputs(ret, model.predict(ret, bat), 20)
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    log(f"  launches over {NSCANS} scans: {launches} (per forward "
        f"{PER_FORWARD})")
    for k, n in launches.items():
        if n != NSCANS * PER_FORWARD[k]:
            raise SystemExit(f"{k}: {n} launches, expected "
                             f"{NSCANS * PER_FORWARD[k]}")

    # per-scan latency: warm, then 3 rounds over the distinct scans
    ev = lambda: torch.cuda.Event(enable_timing=True)  # noqa: E731
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(3 * NSCANS):
        a, b = ev(), ev()
        a.record()
        ret, bat = model(exs[i % NSCANS])
        model.predict(ret, bat)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    p50 = times[len(times) // 2]
    mean = sum(times) / len(times)
    log(f"  per-scan ms: p50 {p50:.2f}, mean {mean:.2f}, min {times[0]:.2f}, "
        f"max {times[-1]:.2f} -> {1000.0 / mean:.2f} scans/s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # branch split, one scan at a time
    names = ["image", "vfe", "structures+rulebooks", "convs", "head+predict"]
    split = [0.0] * len(names)
    with torch.inference_mode():
        for i in range(2 * NSCANS):
            ex = exs[i % NSCANS]
            e = [ev() for _ in range(len(names) + 1)]
            e[0].record()
            img_out = model.image_branch(ex)
            e[1].record()
            st = model.lidar_input(ex)
            e[2].record()
            books = model.backbone_mod.structures(st.structure)
            e[3].record()
            bb_out = model.backbone_mod.convs(st, books)
            e[4].record()
            ret, bat = model.head(ex, bb_out, img_out)
            model.predict(ret, bat)
            e[5].record()
            torch.cuda.synchronize()
            if i >= NSCANS:  # the first round warms the split path
                for j in range(len(names)):
                    split[j] += e[j].elapsed_time(e[j + 1]) / NSCANS
    log("  split ms: " + ", ".join(f"{n} {t:.2f}"
                                   for n, t in zip(names, split)))
    result = dict(p50_ms=p50, mean_ms=mean, scans_per_s=1000.0 / mean,
                  split_ms=dict(zip(names, split)))
    return result, launches, model, exs[0]


def profile_scan(model, ex, top=12):
    """One scan's forward + predict under torch.profiler: the share of the
    scan's span in which a kernel ran on the card, and the kernels that
    took the most device time. Returns the busy share (None when the
    profiler recorded no device activity)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ret, bat = model(ex)
        model.predict(ret, bat)
        torch.cuda.synchronize()
    events = prof.events()
    kern = [e for e in events if e.device_type == DeviceType.CUDA]
    if not kern:
        log("  profile: no device activity recorded; busy share not measured")
        return None
    t0 = min(e.time_range.start for e in events)
    t1 = max(e.time_range.end for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    per_name = {}
    for s, e, name in sorted((k.time_range.start, k.time_range.end, k.name)
                             for k in kern):
        tot, cnt = per_name.get(name, (0.0, 0))
        per_name[name] = (tot + (e - s), cnt + 1)
        if cur_e is None or s > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    share = busy / (t1 - t0)
    log(f"  profile of one scan: span {(t1 - t0) / 1e3:.2f} ms, device busy "
        f"{busy / 1e3:.2f} ms ({100 * share:.1f}%), {len(kern)} device "
        f"activities")
    for name, (tot, cnt) in sorted(per_name.items(),
                                   key=lambda kv: -kv[1][0])[:top]:
        log(f"    {tot / 1e3:8.3f} ms {100 * tot / busy:5.1f}% x{cnt:<5d} "
            f"{name[:90]}")
    return share


def main():
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA device "
                         "(torch.cuda.is_available() is False)\n")
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    from lidarseg3d_torch.ops import cuda_build

    log("phase 1: card")
    log(f"  {card}")
    log(f"  {torch.cuda.get_device_name(0)}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log("phase 2: build")
    secs = cuda_build.build()
    log(f"  built {sorted(cuda_build.SOURCES)} in {secs:.1f} s")
    for name, text in sorted(cuda_build.build_logs.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    log("phase 3: main path")
    result, launches, model, ex0 = main_path()
    log("phase 4: kernels against their plain versions")
    report = kernel_checks(model, ex0)
    for row in report:
        row["launches"] = launches[row["name"].split("[")[0]]
    log("phase 5: profile of one scan")
    result["device_busy_share"] = profile_scan(model, ex0)
    log(json.dumps({"main_path": result}))
    log(card)
    log(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
