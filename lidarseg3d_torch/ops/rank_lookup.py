"""Rank-table gather: packed values at grouped query cells.

Counterpart of lidarseg3d_tpu/ops/pallas_lookup.py::lookup_gather (and of
its HBM-resident variant ``_lookup_gather_hbm``) as dispatched by
lidarseg3d_tpu/ops/sparse.py::_gather_cells. The kernel is
``csrc/rank_lookup.cu``; ``gather_cells_plain`` is the element gather of
the JAX package's XLA path, written in PyTorch.
"""

import ctypes

import torch

from . import cuda_build

_SIG = {"rank_lookup": [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                        ctypes.c_longlong, ctypes.c_void_p]}


def gather_cells_plain(packed, cell):
    """packed [B, NCE] int32, cell [G, B, V] int32 in [0, NCE) ->
    [G, B, V] int32 equal to packed[b, cell[g, b, v]]."""
    B, nce = packed.shape
    offs = (torch.arange(B, device=cell.device, dtype=torch.int64)
            * nce).view(1, B, 1)
    return packed.reshape(-1)[cell.to(torch.int64) + offs]


def gather_cells(packed, cell):
    """Same contract as ``gather_cells_plain``. CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if packed.device.type == "cpu":
        return gather_cells_plain(packed, cell)
    if packed.device.type != "cuda" or cell.device != packed.device:
        raise ValueError(f"gather_cells: unsupported devices {packed.device}, "
                         f"{cell.device}")
    if (packed.dtype != torch.int32 or cell.dtype != torch.int32
            or packed.dim() != 2 or cell.dim() != 3
            or cell.shape[1] != packed.shape[0]
            or not packed.is_contiguous() or not cell.is_contiguous()):
        raise ValueError(
            "gather_cells: need contiguous int32 packed [B, NCE] and cell "
            f"[G, B, V]; got {packed.dtype} {tuple(packed.shape)}, "
            f"{cell.dtype} {tuple(cell.shape)}")
    G, B, V = cell.shape
    out = torch.empty_like(cell)
    if cell.numel() == 0:
        return out
    lib = cuda_build.load("rank_lookup", _SIG)
    err = lib.rank_lookup(packed.data_ptr(), packed.shape[1], cell.data_ptr(),
                          out.data_ptr(), G, B, V, cuda_build.stream_of(cell))
    cuda_build.check(err, "rank_lookup")
    gather_cells.launches += 1
    return out


gather_cells.launches = 0
