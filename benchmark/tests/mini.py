"""A cell of the benchmark cut to a CPU-sized copy for its tests: the
configuration's published model on a 16 m grid of 0.05 x 0.05 x 0.1 m
cells (large enough that the port's first stage takes the sorted-keys
table, as the published grid does), a 128x64 camera, and by default
scans of 1,200-1,500 returns within 5 m and capacities of 1536."""

import re
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

from segbench import spec  # noqa: E402

SUBS = [
    (r"point_cloud_range = \[[^\]]*\]",
     "point_cloud_range = [-8.0, -8.0, -2.0, 8.0, 8.0, 2.0]"),
    (r"voxel_size = \[[^\]]*\]", "voxel_size = [0.05, 0.05, 0.1]"),
    (r"img_resized_shape = \([^)]*\)", "img_resized_shape = (128, 64)"),
    (r"max_voxel_num=\[[^\]]*\]", "max_voxel_num=[{cap}, {cap}]"),
    (r"capacity = dict\([^)]*\)",
     "capacity = dict(max_voxels={cap}, max_points={cap})"),
    (r"npoints=\d+", "npoints={npoints}"),
]


def mini_plan(workload, tmp_path, root=ROOT, points=(1200, 1500),
              max_range=5.0, capacity=1536):
    """The run plan of ``workload`` (``spec.cell``'s) at the CPU size:
    scans of ``points`` returns within ``max_range`` m, capacities of
    ``capacity`` voxels and points."""
    plan = spec.cell(workload, root)
    text = (Path(root) / plan["config_file"]).read_text()
    for pat, rep in SUBS:
        text = re.sub(pat, rep.format(cap=capacity,
                                      npoints=int(0.9 * points[1])), text)
    path = Path(tmp_path) / "mini_config.py"
    path.write_text(text)
    plan["config"] = spec.load_config(path)
    plan["traffic"] = dict(plan["traffic"], points=list(points),
                           max_range=max_range, pool_batches=3,
                           check_batches=2, trace_iterations=2,
                           warm_scans=1)
    return plan
