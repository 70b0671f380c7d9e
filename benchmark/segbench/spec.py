"""What a run reads by name: the cell's entry in ``BENCHMARK.json``, its
configuration file, its traffic file, its limits and its metrics' readers.
Each lives in a file of its own under ``benchmark/``, so a new cell,
configuration, traffic mix or metric is added with new files alone."""

import copy
import importlib.util
import json
import runpy
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]  # the checkout


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_config(path):
    """The configuration file's top-level names as plain data."""
    ns = runpy.run_path(str(path))
    return copy.deepcopy({k: v for k, v in ns.items()
                          if not k.startswith("_")})


def load_traffic(name, bench):
    """The traffic mix ``traffic/<name>.json``."""
    return load_json(Path(bench) / "traffic" / f"{name}.json")


def metric_reader(name, bench):
    """The module that reads metric ``name``: ``metrics/<name>.py``, else
    the reader of its family, ``metrics/<part before the first dot>.py``
    (``idle_pct.train`` and ``idle_pct.infer`` share ``idle_pct.py``)."""
    base = Path(bench) / "metrics"
    path = base / f"{name}.py"
    if not path.exists():
        path = base / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        "segbench_metric_" + path.stem.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def applies(metric, workload):
    return "workloads" not in metric or workload in metric["workloads"]


def cell(workload, root=ROOT):
    """The run's plan for ``workload``: {"workload", "chips", "config"
    (plain data), "config_file", "traffic" (its data, with its "name"),
    "limits", "end_to_end" and "per_layer" (the metric entries that apply
    to it), "readers" (each metric's reader module)}, read from the
    checkout at ``root``."""
    bench = Path(root) / "benchmark"
    bench_json = load_json(Path(root) / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench_json["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    conf = {c["name"]: c for c in bench_json["configs"]}[w["config"]]
    traffic = dict(load_traffic(w["traffic"], bench), name=w["traffic"])
    plan = {
        "workload": workload, "chips": int(w["chips"]),
        "config": load_config(Path(root) / conf["file"]),
        "config_file": conf["file"], "traffic": traffic,
        "limits": load_json(bench / "limits" / f"{workload}.json"),
        "end_to_end": [m for m in bench_json["end_to_end"]
                       if applies(m, workload)],
        "per_layer": [m for m in bench_json["per_layer"]
                      if applies(m, workload)],
    }
    plan["readers"] = {m["name"]: metric_reader(m["name"], bench)
                       for m in plan["end_to_end"] + plan["per_layer"]}
    return plan
