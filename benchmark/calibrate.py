"""Readings the limits of a cell's check are set from (not run by the
benchmark's runs): on each of ``--seeds``, a run of the cell with a short
window (what the program's timed path gives against the reference); on
each of ``--control-seeds``, the control (the reference with TF32 on, in
the program's place) and, for a train cell, the fault of half the batch
left out (the reference on the first half of each batch's rows) against
the reference. One JSON line per reading goes to ``--out`` and standard
output.

    python3 benchmark/calibrate.py --workload CELL --seeds 1,2,... \\
        --control-seeds 7,8,9 [--seconds 2] [--out FILE]
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import run as bench_run  # noqa: E402


def half_batch(pool):
    """Each batch with the first half of its rows (of its cameras' label
    maps, whose rows are the frames' cameras)."""
    out = []
    for batch in pool:
        B = batch["points"].shape[0]
        out.append({k: (v[:max(1, B // 2)] if hasattr(v, "shape")
                        and v.ndim and v.shape[0] == B else v)
                    for k, v in batch.items()})
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    bench_run._env()
    import torch

    from segbench import cell, compare, pool as pool_mod, spec, weights
    import segref

    device = torch.device("cuda", 0)
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(dict(rec, workload=args.workload))
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    plan = spec.cell(args.workload)
    t0 = T_START
    for s in filter(None, args.seeds.split(",")):
        res = cell.run(plan, int(s), args.seconds, False, device, t0,
                       log=lambda m: print(m, file=sys.stderr, flush=True))
        emit({"seed": int(s), "kind": "program", "correct": res["correct"],
              "values": {k: c["value"] for k, c in res["checks"].items()},
              "setup_s": res["metrics"]["setup_s"]["value"]})
        t0 = time.perf_counter()
    cfg, traffic = plan["config"], plan["traffic"]
    B = cell.batch_size(cfg, traffic)
    pshapes, bshapes = weights.shapes_of(segref.build(cell.model_cfg(cfg)))
    for s in filter(None, args.control_seeds.split(",")):
        seed = int(s)
        wts = weights.draw(pshapes, bshapes, seed, device)
        pool = pool_mod.build_pool(cfg, traffic, seed, B)
        train = traffic["mode"] == "train"
        batches = None if train else list(range(len(pool)))
        tta = bool(traffic.get("tta"))
        ref = compare.reference_outputs(cfg, traffic, pool, wts, seed,
                                        device, B, batches)
        low = compare.reference_outputs(cfg, traffic, pool, wts, seed,
                                        device, B, batches, lower=True)
        emit({"seed": seed, "kind": "control",
              "values": compare.numbers(traffic["mode"], low, ref, pool,
                                        tta)})
        if train:
            half = compare.reference_outputs(cfg, traffic, half_batch(pool),
                                             wts, seed, device, B)
            emit({"seed": seed, "kind": "fault_half_batch",
                  "values": compare.numbers("train", half, ref, pool)})
        del wts, pool, ref, low
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
