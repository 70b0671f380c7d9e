"""The harness end to end at the CPU size: set-up, the window, the check
against the reference and the metrics, for each cell of BENCHMARK.json;
and ``run.py`` on a machine without a card."""

import json
import subprocess
import sys
import time

import pytest
import torch
from mini import BENCH, ROOT, mini_plan

from segbench import cell

CELLS = ["mseg3d-semkitti.train", "sdseg3d-semkitti.train",
         "mseg3d-semkitti.infer", "sdseg3d-semkitti.infer-tta"]
SEED = 2**31 + 4099  # the driver's seeds pass 32 signed bits


def run_mini(plan, trace=False, seconds=0.3):
    return cell.run(plan, SEED, seconds, trace, torch.device("cpu"),
                    time.perf_counter(), log=lambda m: None)


@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_and_checks_at_cpu_size(workload, tmp_path, cpu_threads):
    plan = mini_plan(workload, tmp_path)
    res = run_mini(plan)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {m["name"] for m in plan["end_to_end"]}
    for name, m in res["metrics"].items():
        assert m["value"] > 0, name
    assert res["device"]["platform"] == "cpu"


def test_traced_run_reads_the_trace(tmp_path, cpu_threads):
    plan = mini_plan("sdseg3d-semkitti.infer-tta", tmp_path)
    res = run_mini(plan, trace=True)
    assert res["correct"], res["checks"]
    # on the CPU the profiler records no device activity, so only the
    # metric read from the reference's operation count is there
    assert set(res["metrics"]) == {"mfu_pct.infer"}
    assert 0 < res["metrics"]["mfu_pct.infer"]["value"] < 100
    assert res["device"]["busy_s"] == 0.0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_run_without_a_card_prints_no_result():
    proc = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", CELLS[2],
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
             "HOME": str(ROOT)})
    assert proc.returncode == 2, proc.stderr[-2000:]
    assert proc.stdout.strip() == ""


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_the_card(workload, card):
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload,
         "--seed", str(SEED), "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
