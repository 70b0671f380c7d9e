"""One run of one cell: set-up, the measured window, the traced window
(``--trace 1``), then the check of what the window produced against the
reference, and the metrics.

Set-up (``setup_s``, from the process's start): torch, the port's kernel
libraries (built only by a checkout's first run), the port's model from
the configuration, the benchmark's seeded weights loaded into it, the
pool of host batches, and the first steps: a train cell's three checked
steps, an infer cell's two warm scans.

Train cells drive ``apis.train.make_train_step`` in a closed loop over the
pool, each step copying its host batch to the card
(``apis.train.example_to_device``); the window ends on a
synchronisation. Infer cells label one scan (a TTA frame: its variants as
the rows of one batch) at a time through ``make_eval_step``, each timed
on the host clock from the hand-over of its host batch to its labels on
the host, as ``apis.eval.run_eval`` brings them there.
"""

import gc
import math
import time

import numpy as np

from . import compare, pool as pool_mod, trace as trace_mod, weights

PEAK_FLOPS = 495e12  # TF32 dense, the fastest fp32-accurate rate of an H100
PEAK_BYTES = 3.35e12


def input_shape(cfg):
    """(Z + 1, Y, X) of the configuration's voxel grid, as the port's tools
    hand it to the model."""
    vg = cfg["voxel_generator"]
    rng = np.asarray(vg["range"], np.float32)
    vs = np.asarray(vg["voxel_size"], np.float32)
    g = np.round((rng[3:] - rng[:3]) / vs).astype(int)
    return (int(g[2]) + 1, int(g[1]), int(g[0]))


def model_cfg(cfg):
    m = dict(cfg["model"])
    m.setdefault("train_cfg", dict(cfg.get("train_cfg") or {}))
    m.setdefault("test_cfg", dict(cfg.get("test_cfg") or {}))
    return m


def batch_size(cfg, traffic):
    b = traffic["batch"]
    return int(cfg["data"]["samples_per_gpu"]) if b == "config" else int(b)


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def schedule_steps(cfg, traffic, B):
    """The OneCycle schedule's length: the configuration's epochs of the
    traffic's epoch at B scans a step."""
    return int(cfg["total_epochs"]) * (int(traffic["epoch_scans"]) // B)


def _optimizer(cfg, traffic, B):
    from lidarseg3d_torch.solver.optim import build_one_cycle_optimizer

    clip = cfg["optimizer_config"].get("grad_clip", {}).get("max_norm", 35.0)
    tx, _ = build_one_cycle_optimizer(dict(cfg["optimizer"]),
                                      dict(cfg["lr_config"]),
                                      schedule_steps(cfg, traffic, B),
                                      grad_clip=clip)
    return tx


class TrainLoop:
    """The port's train step over the pool; set-up runs the three steps
    the reference follows."""

    def __init__(self, model, cfg, traffic, B, seed, device, pool, init):
        import torch
        from lidarseg3d_torch.apis import train as api

        self.api, self.pool, self.device = api, pool, device
        self.tx = _optimizer(cfg, traffic, B)
        self.state = api.create_train_state(model, self.tx, seed=seed + 1)
        self.step = api.make_train_step(model, self.tx, input_shape(cfg))
        self.B = B
        names = [n for n, _ in model.named_parameters()]
        self.checked = {"losses": []}
        for i in range(traffic["check_steps"]):
            _, ld = self.run(i)
            self.checked["losses"].append(float(ld["loss"]))
            if i == 0:
                b1 = self.tx.b1_fn(0)
                g = torch.stack(torch._foreach_norm(self.state.opt_state.mu))
                self.checked["grad"] = dict(zip(
                    names, (g.double().cpu() / (1.0 - b1)).tolist()))
        params = dict(model.named_parameters())
        self.checked["change"] = {
            n: float(torch.linalg.vector_norm(params[n].detach() - init[n]))
            for n in names}
        self.next = traffic["check_steps"]

    def run(self, i):
        b = i % len(self.pool)
        self.state, ld = self.step(
            self.state, self.api.example_to_device(self.pool[b], self.device))
        return b, ld

    def iterate(self):
        i = self.next
        self.next += 1
        return self.run(i)[0], self.B


class InferLoop:
    """The port's eval step, one scan (or TTA frame) at a time, its labels
    brought to the host; ``keep`` holds the outputs of the sampled pool
    batches for the check."""

    def __init__(self, model, cfg, traffic, seed, device, pool):
        from lidarseg3d_torch.apis import train as api

        self.api, self.pool, self.device = api, pool, device
        self.state = api.TrainState(step=0, model=model, opt_state=None,
                                    generator=None)
        self.step = api.make_eval_step(model, input_shape(cfg))
        self.tta = int(traffic.get("tta", {}).get("num_tta_tranforms", 0))
        rng = np.random.default_rng([seed, 0xC4EC])
        self.sampled = set(rng.choice(len(pool), traffic["check_batches"],
                                      replace=False).tolist())
        self.keep = {}
        self.latencies = []
        self.next = 0
        for _ in range(traffic["warm_scans"]):
            self.iterate()
        self.latencies.clear()

    def iterate(self):
        import torch

        b = self.next % len(self.pool)
        self.next += 1
        batch = self.pool[b]
        t0 = time.perf_counter()
        out = self.step(self.state,
                        self.api.example_to_device(batch, self.device))
        npts = batch["num_points_total"]
        if self.tta:  # run_eval's merge of a frame's variants
            sm = out["point_softmax"].float().cpu().numpy()
            labels = [np.argmax(sm[:, :int(npts[0])].mean(0), axis=-1)]
        else:
            lab = out["pred_point_sem_labels"].to(torch.int32).cpu().numpy()
            labels = [lab[r, :int(npts[r])] for r in range(len(npts))]
        self.latencies.append(time.perf_counter() - t0)
        if b in self.sampled:
            self.keep[b] = (out["point_softmax"], labels)
        return b, 1 if self.tta else len(npts)


def window(loop, seconds, device):
    """Iterate for ``seconds`` -> (seconds to the closing synchronisation,
    scans, the pool batch of each iteration)."""
    _sync(device)
    ids, scans = [], 0
    t0 = time.perf_counter()
    while True:
        b, n = loop.iterate()
        ids.append(b)
        scans += n
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(device)
    return time.perf_counter() - t0, scans, ids


def traced_window(loop, iterations, device, instruments, ctx):
    """``iterations`` under torch.profiler, with each metric's
    ``instrument(ctx)`` hooks in place -> (the trace, scans, the pool
    batch of each iteration)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    handles = [h for inst in instruments for h in inst(ctx)]
    try:
        _sync(device)
        ids, scans = [], 0
        with profile(activities=acts) as prof:
            for _ in range(iterations):
                b, n = loop.iterate()
                ids.append(b)
                scans += n
            _sync(device)
    finally:
        for h in handles:
            h.remove()
    return trace_mod.read(prof), scans, ids


def reference_passes(cfg, mode, pool, wts, seed, device, B):
    """Operation counts of the reference over every pool batch: FLOPs of
    the forward (and backward, for training) and each conv's record."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    import segref
    from segref import sparse as ref_sparse

    model = segref.build(model_cfg(cfg)).to(device)
    model.load_state_dict(wts, strict=True)
    shape = input_shape(cfg)
    flops, convs = [], []
    for batch in pool:
        ex = dict(segref.to_device(batch, device), input_shape=shape)
        records = []
        counter = FlopCounterMode(display=False)
        with counter, ref_sparse.record_convs(records):
            if mode == "train":
                model.train()
                model.zero_grad(set_to_none=True)
                gen = torch.Generator(device=device).manual_seed(seed + 1)
                ret, bat = model(ex, generator=gen)
                loss, _ = model.loss(ret, bat)
                loss.backward()
            else:
                model.eval()
                ret, bat = model(ex)
                model.predict(ret, bat)
        flops.append(float(counter.get_total_flops()))
        convs.append(records)
        del ex, ret, bat
    del model
    return flops, convs


def run(spec, seed, seconds, trace, device, t_start, log=print):
    """The cell's run -> the result the command prints: "correct",
    "attempted", "failed", "metrics", "device", with ``trace`` a
    "breakdown", and last "checks", each compared number with its
    limit."""
    import torch

    cfg, traffic = spec["config"], spec["traffic"]
    mode = traffic["mode"]
    B = batch_size(cfg, traffic)
    from lidarseg3d_torch.models import build_detector
    from lidarseg3d_torch.ops import cuda_build

    cuda_build.build(None if device.type == "cuda"
                     else list(cuda_build.HOST_SOURCES))
    model = build_detector(model_cfg(cfg), device=device)
    pshapes, bshapes = weights.shapes_of(model)
    wts = weights.draw(pshapes, bshapes, seed, device)
    model.load_state_dict(wts, strict=True)
    pool = pool_mod.build_pool(cfg, traffic, seed, B)
    if mode == "train":
        loop = TrainLoop(model, cfg, traffic, B, seed, device, pool, wts)
    else:
        loop = InferLoop(model, cfg, traffic, seed, device, pool)
    # what set-up made lives through the run: the collector's passes in
    # the window scan only what the window makes
    gc.collect()
    gc.freeze()
    _sync(device)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s; pool {len(pool)} batches of {B}")

    on_card = device.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    window_s, scans, ids = window(loop, seconds, device)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    ctx = dict(mode=mode, workload=spec["workload"], batch_size=B,
               setup_s=setup_s, window_s=window_s, scans=scans,
               window_ids=ids, latencies_s=list(getattr(loop, "latencies",
                                                        [])),
               peak_bytes=peak, model=model, trace=None,
               peak_flops=PEAK_FLOPS, peak_bytes_per_s=PEAK_BYTES)
    log(f"window {window_s:.3f} s, {scans} scans, {len(ids)} iterations")
    if trace:
        readers = [spec["readers"][m["name"]] for m in spec["per_layer"]]
        tr, t_scans, t_ids = traced_window(
            loop, traffic["trace_iterations"], device,
            [r.instrument for r in readers if hasattr(r, "instrument")], ctx)
        ctx.update(trace=tr, trace_scans=t_scans, trace_ids=t_ids)
    process_peak = max(setup_peak, torch.cuda.max_memory_allocated(device)
                       if on_card else 0)

    # the program's outputs for the check; then its state goes
    if mode == "train":
        program = loop.checked
    else:
        program = {b: (sm.float().cpu().numpy(), labels)
                   for b, (sm, labels) in loop.keep.items()}
    ctx.pop("model")
    del loop, model
    gc.unfreeze()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    checks = compare.check(cfg, traffic, pool, program, wts, seed, device, B,
                           spec["limits"])
    if trace:
        flops, convs = reference_passes(cfg, mode, pool, wts, seed, device,
                                        B)
        ctx.update(pool_flops=flops, pool_convs=convs)
    metrics = {}
    entries = spec["per_layer"] if trace else spec["end_to_end"]
    for m in entries:
        reader = spec["readers"][m["name"]]
        v = reader.read(ctx, m["name"])
        if v is None:
            continue
        if not math.isfinite(v):
            raise ValueError(f"{m['name']} read {v}")
        metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": scans, "failed": 0, "metrics": metrics,
        "device": {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
                   "count": 1, "memory_peak_bytes": int(process_peak)},
    }
    if trace:
        tr = ctx["trace"]
        result["device"].update(busy_s=tr.busy_s(), window_s=tr.window_s())
        result["breakdown"] = trace_mod.breakdown(tr)
    result["checks"] = checks
    return result
