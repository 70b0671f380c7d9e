"""The control of every cell comes out not correct: the reference computed
with TF32 (here: its matrix products and convolutions fed inputs rounded
to TF32's 10-bit mantissa), put in the program's place, fails one of the
cell's limits at least; the port's own CPU path passes them all."""

import pytest
import torch
from mini import mini_plan

import segref
from segbench import cell, compare, pool as pool_mod, weights

CELLS = ["mseg3d-semkitti.train", "sdseg3d-semkitti.train",
         "mseg3d-semkitti.infer", "sdseg3d-semkitti.infer-tta"]
SEED = 2**31 + 77
# TF32's error in a TTA frame's merged softmax grows with the scan: at
# 1,500 returns it reads under the cell's limit (chip readings: PERF.md)
SIZES = {"sdseg3d-semkitti.infer-tta": dict(points=(6000, 7000),
                                            max_range=7.5, capacity=8192)}


def readings(plan, lower):
    cfg, traffic = plan["config"], plan["traffic"]
    dev = torch.device("cpu")
    B = cell.batch_size(cfg, traffic)
    pshapes, bshapes = weights.shapes_of(segref.build(cell.model_cfg(cfg)))
    wts = weights.draw(pshapes, bshapes, SEED, dev)
    pool = pool_mod.build_pool(cfg, traffic, SEED, B)
    batches = (None if traffic["mode"] == "train"
               else list(range(len(pool))))
    ref = compare.reference_outputs(cfg, traffic, pool, wts, SEED, dev, B,
                                    batches)
    other = compare.reference_outputs(cfg, traffic, pool, wts, SEED, dev, B,
                                      batches, lower=lower)
    return compare.numbers(traffic["mode"], other, ref, pool,
                           bool(traffic.get("tta")))


@pytest.mark.parametrize("workload", CELLS)
def test_lower_precision_control_fails(workload, tmp_path, cpu_threads):
    plan = mini_plan(workload, tmp_path, **SIZES.get(workload, {}))
    got = readings(plan, lower=True)
    failed = [k for k, lim in plan["limits"].items() if got[k] > lim]
    assert failed, (got, plan["limits"])


@pytest.mark.parametrize("workload", CELLS)
def test_reference_is_deterministic(workload, tmp_path, cpu_threads):
    plan = mini_plan(workload, tmp_path)
    assert all(v == 0.0 for v in readings(plan, lower=False).values())
