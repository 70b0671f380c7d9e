"""Sorted-keys merge lookup: RankTable-equivalent packed values from a
KeyTable's sorted keys, with no dense table.

Counterpart of lidarseg3d_tpu/ops/pallas_merge.py::merge_gather as
dispatched by lidarseg3d_tpu/ops/sparse.py::_merge_cells. The kernel is
``csrc/merge_lookup.cu``: a block of THREADS threads answers a tile of
THREADS * KPER queries of one (group, sample) row from a window of at
most WINDOW keys that it stages in shared memory (the key positions
between the block ranks ``coarse`` of the tile's smallest and largest
query); a query whose bracket ends beyond the window is searched in device
memory in the same loop. ``merge_cells_plain`` is the JAX package's
``merge_gather_xla`` oracle written with ``torch.searchsorted``.

For a query cell q of sample b, both return

    (rank << 3) | act(q-1) << 2 | act(q) << 1 | act(q+1)

with rank = #{valid keys <= q} and act(c) whether c is a valid key: what a
RankTable gather returns at q.
"""

import ctypes

import torch

from . import cuda_build

_SIG = {"merge_lookup": [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                         ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                         ctypes.c_longlong, ctypes.c_longlong,
                         ctypes.c_void_p, ctypes.c_void_p]}
THREADS = 256  # threads a block (csrc/merge_lookup.cu kThreads)
KPER = 2  # queries a thread, THREADS apart (kPer)
WINDOW = 1024  # keys a block stages in shared memory (kWindow)
# the kernel's optional counters: tiles served wholly from their window,
# partly, not at all; queries searched in device memory
PATHS = ("window", "mixed", "global", "global_queries")


def merge_cells_plain(keys, num, cells):
    """keys [B, Vk] int32 ascending with INVALID_KEY after num[b]; num [B];
    cells [G, B, V] int32 -> [G, B, V] int32 packed values."""
    G, B, V = cells.shape
    q = cells.permute(1, 0, 2).reshape(B, G * V).contiguous()
    nv = num.to(torch.int64)[:, None]
    rank = torch.minimum(torch.searchsorted(keys, q, right=True), nv)

    def has(c):
        p = torch.searchsorted(keys, c)
        k = torch.gather(keys, 1, p.clamp(max=keys.shape[1] - 1))
        return ((k == c) & (p < nv)).to(torch.int64)

    out = (rank << 3) | (has(q - 1) << 2) | (has(q) << 1) | has(q + 1)
    return out.to(torch.int32).reshape(B, G, V).permute(1, 0, 2).contiguous()


def merge_cells(keys, coarse, shift, num, cells, paths=None):
    """Same contract as ``merge_cells_plain``, given also the KeyTable's
    block ranks ``coarse`` [B, NB + 1] (coarse[b, j] = #{valid keys <
    j << shift}, every valid key below NB << shift), which bracket the
    kernel's windows and searches. CPU tensors take the plain version;
    CUDA tensors launch the kernel. ``paths``, an int64 CUDA tensor [4],
    if given, has the kernel's counters (PATHS) added to it."""
    if keys.device.type == "cpu":
        return merge_cells_plain(keys, num, cells)
    if (keys.device.type != "cuda" or cells.device != keys.device
            or num.device != keys.device or coarse.device != keys.device):
        raise ValueError(f"merge_cells: unsupported devices {keys.device}, "
                         f"{coarse.device}, {num.device}, {cells.device}")
    B = keys.shape[0] if keys.dim() == 2 else -1
    if (keys.dtype != torch.int32 or cells.dtype != torch.int32
            or num.dtype != torch.int32 or coarse.dtype != torch.int32
            or keys.dim() != 2 or cells.dim() != 3 or coarse.dim() != 2
            or tuple(num.shape) != (B,) or cells.shape[1] != B
            or coarse.shape[0] != B or coarse.shape[1] < 2
            or not keys.is_contiguous() or not cells.is_contiguous()
            or not coarse.is_contiguous()
            or (paths is not None and (paths.dtype != torch.int64
                                       or tuple(paths.shape) != (4,)
                                       or paths.device != keys.device))):
        raise ValueError(
            "merge_cells: need contiguous int32 keys [B, Vk], coarse "
            "[B, NB + 1], num [B] and cells [G, B, V]; got "
            f"{keys.dtype} {tuple(keys.shape)}, {coarse.dtype} "
            f"{tuple(coarse.shape)}, {num.dtype} {tuple(num.shape)}, "
            f"{cells.dtype} {tuple(cells.shape)}, and paths int64 [4] or "
            "None")
    G, B, V = cells.shape
    out = torch.empty_like(cells)
    if cells.numel() == 0:
        return out
    lib = cuda_build.load("merge_lookup", _SIG)
    err = lib.merge_lookup(keys.data_ptr(), keys.shape[1], coarse.data_ptr(),
                           coarse.shape[1] - 1, int(shift), num.data_ptr(),
                           cells.data_ptr(), out.data_ptr(), G, B, V,
                           None if paths is None else paths.data_ptr(),
                           cuda_build.stream_of(cells))
    cuda_build.check(err, "merge_lookup")
    merge_cells.launches += 1
    return out


merge_cells.launches = 0
