"""The benchmark of lidarseg3d_torch (the PyTorch + CUDA port): one run of
one cell of ``BENCHMARK.json``.

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

run from the root of a checkout on a machine with an NVIDIA card. It
prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace
1`` a ``breakdown``, and last ``checks``, each compared number beside its
limit; standard error ends with the same numbers. Without a card, or
with fewer cards than the cell asks for, it prints no result and exits
with 2; if JAX or the JAX package was loaded, with 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "lidarseg3d_tpu")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _env():
    """Any compile cache a run writes lives at a fixed path of the
    checkout (the port's own kernel libraries go to
    ``lidarseg3d_torch/build/``); the checkout and the benchmark's
    packages are importable."""
    cache = BENCH / ".cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(cache / "torch_extensions"))
    for p in (str(ROOT), str(BENCH)):
        if p not in sys.path:
            sys.path.insert(0, p)


def main(argv=None):
    args = parse_args(argv)
    _env()
    from segbench import cell, spec

    plan = spec.cell(args.workload)
    import torch

    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < plan["chips"]):
        print(f"{args.workload} needs {plan['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    result = cell.run(plan, args.seed, args.seconds, bool(args.trace),
                      device, T_START, log=log)
    found = forbidden_modules()
    if found:
        print(f"modules that no run may load: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
