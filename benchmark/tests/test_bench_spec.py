"""A cell is found by its names alone: a traffic mix added as a file,
with its cell's entry and limits, runs with no edit to a file that is
there; a metric's reader is found by its name or its family's."""

import json
import shutil
import time

import torch
from mini import ROOT, mini_plan

from segbench import cell, spec


def copy_benchmark(dst):
    dst.mkdir(parents=True)
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(ROOT / "benchmark" / sub, dst / "benchmark" / sub)


def test_new_traffic_file_is_found_by_name(tmp_path, cpu_threads):
    root = tmp_path / "checkout"
    copy_benchmark(root)
    bench = root / "benchmark"
    infer = json.loads((bench / "traffic" / "infer.json").read_text())
    infer.update(points=[900, 1000], about="a smaller scan")
    (bench / "traffic" / "sparse-scans.json").write_text(json.dumps(infer))
    shutil.copy(bench / "limits" / "mseg3d-semkitti.infer.json",
                bench / "limits" / "mseg3d-semkitti.sparse-scans.json")
    bj = json.loads((root / "BENCHMARK.json").read_text())
    bj["workloads"].append({
        "name": "mseg3d-semkitti.sparse-scans", "config": "mseg3d-semkitti",
        "traffic": "sparse-scans", "chips": 1, "why": "smaller scans"})
    for m in bj["end_to_end"] + bj["per_layer"]:
        if "mseg3d-semkitti.infer" in m.get("workloads", ()):
            m["workloads"].append("mseg3d-semkitti.sparse-scans")
    (root / "BENCHMARK.json").write_text(json.dumps(bj))

    plan = spec.cell("mseg3d-semkitti.sparse-scans", root)
    assert plan["traffic"]["name"] == "sparse-scans"
    assert plan["traffic"]["about"] == "a smaller scan"
    mini = mini_plan("mseg3d-semkitti.sparse-scans", tmp_path, root)
    mini["traffic"]["points"] = [900, 1000]
    res = cell.run(mini, 11, 0.2, False, torch.device("cpu"),
                   time.perf_counter(), log=lambda m: None)
    assert res["correct"] and res["attempted"] > 0


def test_metric_readers_are_found_by_name_or_family():
    bench = ROOT / "benchmark"
    assert spec.metric_reader("idle_pct.train", bench).__file__.endswith(
        "idle_pct.py")
    assert spec.metric_reader("setup_s", bench).__file__.endswith(
        "setup_s.py")
    bj = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in bj["end_to_end"] + bj["per_layer"]:
        assert hasattr(spec.metric_reader(m["name"], bench), "read")
