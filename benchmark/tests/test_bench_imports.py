"""No run loads JAX or the JAX package, and the reference loads nothing
of the port: modules are compared by their whole top-level name (the
port's name begins with the JAX package's)."""

import ast
import json
import subprocess
import sys

from mini import BENCH, ROOT

FORBIDDEN_IN_RUN = {"jax", "jaxlib", "flax", "lidarseg3d_tpu"}
FORBIDDEN_IN_REF = FORBIDDEN_IN_RUN | {"lidarseg3d_torch"}

RUN_MINI = """
import json, sys, time
sys.path[:0] = [{root!r}, {bench!r}, {tests!r}]
import torch
torch.set_num_threads(2)
from mini import mini_plan
from segbench import cell
plan = mini_plan("mseg3d-semkitti.infer", {tmp!r})
res = cell.run(plan, 5, 0.2, False, torch.device("cpu"), time.perf_counter(),
               log=lambda m: None)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REF_ONLY = """
import json, sys
sys.path[:0] = [{bench!r}]
import segref
from segbench import spec
cfg = spec.load_config({cfg!r})
segref.build(dict(cfg["model"]))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level_modules(code):
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax(tmp_path):
    mods = top_level_modules(RUN_MINI.format(
        root=str(ROOT), bench=str(BENCH), tests=str(BENCH / "tests"),
        tmp=str(tmp_path)))
    assert "lidarseg3d_torch" in mods
    assert not mods & FORBIDDEN_IN_RUN


def test_the_reference_loads_nothing_of_the_port():
    mods = top_level_modules(REF_ONLY.format(
        bench=str(BENCH), cfg=str(BENCH / "configs" / "mseg3d-semkitti.py")))
    assert "segref" in mods
    assert not mods & FORBIDDEN_IN_REF


def test_the_reference_imports_nothing_of_the_port():
    for path in sorted((BENCH / "segref").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            tops = {n.split(".")[0] for n in names}
            assert not tops & FORBIDDEN_IN_REF, (path.name, names)
