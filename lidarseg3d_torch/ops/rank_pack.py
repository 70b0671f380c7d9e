"""Rank-table pack: int8 activity bitmap -> packed int32 rank table.

Counterpart of lidarseg3d_tpu/ops/pallas_rank.py::pack_rank_table. The
kernel is ``csrc/rank_pack.cu`` (a block scan); ``pack_rank_table_plain``
is the XLA formulation of lidarseg3d_tpu/ops/coords.py build_rank_table
written in PyTorch, used for CPU tensors and as the kernel's reference.

    packed[c] = rank(c) << 3 | act(c-1) << 2 | act(c) << 1 | act(c+1)

with rank the inclusive prefix sum of act and neighbours outside the table
counted inactive.
"""

import ctypes

import torch

from . import cuda_build

_SIG = {"rank_pack": [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]}
BLOCK = 8192  # cells per block of the kernel (csrc/rank_pack.cu kBlock)


def pack_rank_table_plain(act):
    """act [NCE] int8 0/1 -> packed [NCE] int32 (plain PyTorch)."""
    a = act.to(torch.int32)
    rank = torch.cumsum(a, 0, dtype=torch.int32)
    zero = a.new_zeros(1)
    am = torch.cat([zero, a[:-1]])
    ap = torch.cat([a[1:], zero])
    return (rank << 3) | (am << 2) | (a << 1) | ap


def pack_rank_table(act):
    """act [NCE] int8 0/1 -> packed [NCE] int32.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if act.device.type == "cpu":
        return pack_rank_table_plain(act)
    if act.device.type != "cuda":
        raise ValueError(f"pack_rank_table: unsupported device {act.device}")
    if act.dtype != torch.int8 or act.dim() != 1 or not act.is_contiguous():
        raise ValueError("pack_rank_table: act must be a contiguous 1-D int8 "
                         f"tensor, got {act.dtype} {tuple(act.shape)}")
    nce = act.shape[0]
    out = torch.empty(nce, dtype=torch.int32, device=act.device)
    if nce == 0:
        return out
    nb = -(-nce // BLOCK)
    tot = torch.empty(nb, dtype=torch.int32, device=act.device)
    offs = torch.empty(nb + 1, dtype=torch.int32, device=act.device)
    lib = cuda_build.load("rank_pack", _SIG)
    err = lib.rank_pack(act.data_ptr(), nce, tot.data_ptr(), offs.data_ptr(),
                        out.data_ptr(), cuda_build.stream_of(act))
    cuda_build.check(err, "rank_pack")
    pack_rank_table.launches += 1
    return out


pack_rank_table.launches = 0
