"""Rank-table pack: int8 activity bitmap rows -> packed int32 rank tables.

Counterpart of lidarseg3d_tpu/ops/pallas_rank.py::pack_rank_table, which the
JAX package's build_rank_table calls once per sample. The kernel is
``csrc/rank_pack.cu`` (one launch for all samples: a single-pass scan with
decoupled look-back); ``pack_rank_table_plain`` is the XLA formulation of
lidarseg3d_tpu/ops/coords.py build_rank_table written in PyTorch, used for
CPU tensors and as the kernel's reference.

    packed[b, c] = rank(c) << 3 | act(c-1) << 2 | act(c) << 1 | act(c+1)

with rank the inclusive prefix sum of row b of act and neighbours outside
the table counted inactive.
"""

import ctypes

import torch

from ..utils import remat
from . import cuda_build

_SIG = {"rank_pack": [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                      ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_longlong, ctypes.c_void_p]}
THREADS = 256  # threads a block (csrc/rank_pack.cu kThreads)
TILE = 8192  # cells per tile of the kernel (csrc/rank_pack.cu kTile)
HEADER = 2  # workspace words before the status words (kHeader)
EPOCH_MASK = 2**30 - 1  # the epoch (word 0 >> 32) wraps to 0 after it


def _check_rows(act, nce):
    if act.dim() != 2 or not 0 <= nce <= act.shape[1]:
        raise ValueError("pack_rank_table: need act [B, L] and 0 <= nce <= "
                         f"L, got {tuple(act.shape)} and nce={nce}")


def pack_rank_table_plain(act, nce):
    """act [B, L] int8 0/1 -> packed [B, nce] int32 from the first ``nce``
    cells of each row."""
    nce = int(nce)
    _check_rows(act, nce)
    a = act[:, :nce].to(torch.int32)
    rank = torch.cumsum(a, 1, dtype=torch.int32)
    zero = a.new_zeros(a.shape[0], 1)
    am = torch.cat([zero, a[:, :-1]], 1)[:, :nce]
    ap = torch.cat([a[:, 1:], zero], 1)[:, :nce]
    return (rank << 3) | (am << 2) | (a << 1) | ap


def tile_count(B, nce):
    """Tiles of one kernel launch: each row's TILE-cell windows of the flat
    [B * nce] output (a window across a row edge is one tile per row)."""
    return sum(((b + 1) * nce - 1) // TILE - b * nce // TILE + 1
               for b in range(B))


# the kernel's workspace of each (device, stream): its epoch and ticket
# counter, a finished-tile count, then the tiles' status words. The kernel
# leaves it ready for the next call, so the wrapper keeps no count. A
# workspace outgrown by a larger table is kept alive (_retired), as a CUDA
# graph that captured a launch on it still reads it on every replay.
_workspaces = {}
_retired = []


def _workspace(device, stream, tiles):
    key = (device.index, stream)
    ws = _workspaces.get(key)
    if ws is None or ws.numel() - HEADER < tiles:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "pack_rank_table: the kernel's workspace must grow to "
                f"{tiles} tiles, which cannot be allocated during CUDA "
                "graph capture; pack the largest table once on the capture "
                "stream before capturing")
        if ws is not None:
            _retired.append(ws)
        ws = _workspaces[key] = torch.zeros(HEADER + max(tiles, 4096),
                                            dtype=torch.int64, device=device)
    return ws


def pack_rank_table(act, nce):
    """act [B, L] int8 0/1, rows at any stride with contiguous cells ->
    packed [B, nce] int32 from the first ``nce`` cells of each row, each
    row ranked from zero. One kernel launch for all rows;
    ``coords.activity``'s [B, NCE + 1] bitmap goes in as it is, with
    ``nce = NCE``.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if act.device.type == "cpu":
        return pack_rank_table_plain(act, nce)
    if act.device.type != "cuda":
        raise ValueError(f"pack_rank_table: unsupported device {act.device}")
    if remat.phase() is not None:
        raise RuntimeError("pack_rank_table: tables are built outside "
                           "recomputed regions (the stream's workspace "
                           "must not be re-entered from a recompute)")
    nce = int(nce)
    _check_rows(act, nce)
    if act.dtype != torch.int8 or (act.numel() > 0 and act.stride(-1) != 1):
        raise ValueError("pack_rank_table: act must be int8 with contiguous "
                         f"rows, got {act.dtype} stride {act.stride()}")
    B = act.shape[0]
    out = torch.empty(B, nce, dtype=torch.int32, device=act.device)
    if B and nce:
        tiles = tile_count(B, nce)
        stream = torch.cuda.current_stream(act.device).cuda_stream
        ws = _workspace(act.device, stream, tiles)
        lib = cuda_build.load("rank_pack", _SIG)
        err = lib.rank_pack(act.data_ptr(), act.stride(0), B, nce,
                            out.data_ptr(), ws.data_ptr(),
                            ws.numel() - HEADER, ctypes.c_void_p(stream))
        cuda_build.check(err, "rank_pack")
        pack_rank_table.launches += 1
    return out


pack_rank_table.launches = 0
