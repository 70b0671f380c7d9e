"""Hygiene of the port: lidarseg3d_torch and chip_smoke.py import nothing
of JAX, Flax, the JAX package or __graft_entry__, and the entry point runs
on cuda unless told otherwise."""

import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "lidarseg3d_tpu", "__graft_entry__")


def _files():
    return sorted((ROOT / "lidarseg3d_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax():
    files = _files()
    assert len(files) > 20
    bad = [(str(p.relative_to(ROOT)), m) for p in files
           for m in _imports(p) if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_build_detector_defaults_to_cuda():
    from lidarseg3d_torch.models import build_detector
    from lidarseg3d_torch.synthetic import mseg3d_model_cfg

    cfg = mseg3d_model_cfg(ratio=1, small_hrnet=True)
    if torch.cuda.is_available():
        m = build_detector(cfg)
        assert next(m.parameters()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            build_detector(cfg)


def test_kernel_wrappers_take_plain_version_only_on_cpu():
    """A wrapper given a tensor on another device raises instead of
    falling back."""
    from lidarseg3d_torch.ops.rank_pack import pack_rank_table

    with pytest.raises(ValueError):
        pack_rank_table(torch.zeros(8, dtype=torch.int8, device="meta"))
