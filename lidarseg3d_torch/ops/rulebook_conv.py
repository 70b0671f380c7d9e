"""Fused gather -> GEMM rulebook sparse convolution: forward, weight
gradient, and the autograd function that ties them together.

Counterpart of lidarseg3d_tpu/ops/pallas_conv.py::rulebook_conv_block and
::rulebook_conv_dw as wired by lidarseg3d_tpu/ops/sparse_pallas.py::
fused_conv (custom VJP), at the JAX package's public layout:

    feat [B*Vin + 1, Cin]  (``flat_features``: last row all zeros)
    rb   [K, B, Vout] int32 global flat rows, a miss is B*Vin
    w    [K, Cin, Cout]
    ->   [B, Vout, Cout]

The kernels are ``csrc/rulebook_conv.cu`` (forward, and dX under the
transposed rulebook) and ``csrc/rulebook_conv_dw.cu`` (dW), on the tensor
cores: bf16 as it is, fp32 as 3xTF32 (``csrc/tensor_core.cuh``).
``rulebook_conv_plain`` is lidarseg3d_tpu/ops/sparse.py::_gather_gemm_core
in PyTorch: index_select, matmul, then a sum over taps;
``rulebook_conv_dw_plain`` is its weight gradient written the same way.
Both accumulate in ``promote_types(dtype, float32)``.
"""

import ctypes

import torch

from ..utils.spans import span
from . import cuda_build

_SIG = {"rulebook_conv": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10
        + [ctypes.c_void_p]}
_SIG_DW = {"rulebook_conv_dw": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
           + [ctypes.c_void_p]}
MAX_COUT = 1024  # output columns of either kernel
CONV_TILE_M = 64  # rows of one conv tile (kTileM in rulebook_conv.cu)
CONV_MAX_TAPS = 32  # taps one conv block holds indices for (kMaxTaps)
DW_TILE_M = 32  # rows of one dW step (kTileM in rulebook_conv_dw.cu)
DW_TARGET_BLOCKS = 528  # 4 blocks for each of the H100's 132 SMs


def _acc_dtype(dtype):
    return torch.promote_types(dtype, torch.float32)


def rulebook_conv_plain(feat, rb, w, flip_taps=False, w_t=False, miss=None,
                        zero_row=False):
    """out[m] = sum_k feat[rb[k, m]] @ w[k]: [B, Vout, Cout] in feat's
    dtype. ``flip_taps`` reads rb[K-1-k] for tap k, ``w_t`` takes w as
    [K, Cout, Cin] and multiplies by w[k]^T (so the data gradient is the
    conv of the cotangent under the transposed rulebook with no copies).
    ``miss`` (default: feat's last row, the zero row) is the index of a
    missing partner; it may be feat.shape[0], a row feat does not have.
    ``zero_row`` returns the flat [B*Vout + 1, Cout] with a last row of
    zeros (a flat feature table)."""
    K, B, Vout = rb.shape
    rows = feat.shape[0]
    miss = rows - 1 if miss is None else miss
    if miss not in (rows - 1, rows):
        raise ValueError(f"miss must be {rows - 1} or {rows}; got {miss}")
    if miss == rows:  # the miss row is not stored: gather zeros for it
        feat = torch.cat([feat, feat.new_zeros(1, feat.shape[1])])
    acc_t = _acc_dtype(feat.dtype)
    M = B * Vout
    acc = torch.zeros(M + int(zero_row), w.shape[1 if w_t else 2],
                      dtype=acc_t, device=feat.device)
    for k in range(K):
        g = feat.index_select(0, rb[K - 1 - k if flip_taps else k]
                              .reshape(-1).to(torch.int64))
        acc[:M].addmm_(g.to(acc_t), (w[k].T if w_t else w[k]).to(acc_t))
    out = acc.to(feat.dtype)
    return out if zero_row else out.reshape(B, Vout, -1)


def rulebook_conv_dw_plain(feat, rb, gout):
    """dW[k] = sum_m feat[rb[k, m]] (x) gout[m]: [K, Cin, Cout] in
    ``promote_types(dtype, float32)``. gout: [B*Vout, Cout]."""
    K = rb.shape[0]
    acc_t = _acc_dtype(feat.dtype)
    g32 = gout.to(acc_t)
    out = []
    for k in range(K):
        g = feat.index_select(0, rb[k].reshape(-1).to(torch.int64))
        out.append(g.to(acc_t).T @ g32)
    return torch.stack(out)


def _check_cuda(what, feat, *others):
    if feat.device.type != "cuda" or any(o.device != feat.device
                                         for o in others):
        raise ValueError(
            f"{what}: all tensors must share one CUDA device; got "
            f"{[str(x.device) for x in (feat, *others)]}")


def conv_splits(K, Cin):
    """How many tap groups the conv kernel splits K into (blockIdx.z):
    Cin / 64 for wide inputs, whose blocks would otherwise walk a long
    reduction (27 taps x Cin) on the few active rows of the deep stages;
    each group holds at most CONV_MAX_TAPS taps and none is empty."""
    s = max(1, min(K, Cin // 64), -(-K // CONV_MAX_TAPS))
    return -(-K // -(-K // s))


def rulebook_conv(feat, rb, w, flip_taps=False, w_t=False, miss=None,
                  zero_row=False):
    """Same contract as ``rulebook_conv_plain``. CPU tensors take the plain
    version; CUDA tensors launch the kernel (fp32 or bf16 inputs, fp32
    accumulation, output in the input dtype; Cin and Cout times the
    element size multiples of 4 bytes). One call counts as one launch:
    the kernel plus, when the taps are split, its reduction."""
    if feat.device.type == "cpu":
        return rulebook_conv_plain(feat, rb, w, flip_taps, w_t, miss,
                                   zero_row)
    _check_cuda("rulebook_conv", feat, rb, w)
    K, B, Vout = rb.shape
    rows, Cin = feat.shape
    miss = rows - 1 if miss is None else miss
    Cout = w.shape[1 if w_t else 2]
    es = feat.element_size()
    if (feat.dtype not in (torch.float32, torch.bfloat16)
            or w.dtype != feat.dtype or rb.dtype != torch.int32
            or tuple(w.shape) != ((K, Cout, Cin) if w_t else (K, Cin, Cout))
            or not 0 < Cout <= MAX_COUT or miss not in (rows - 1, rows)
            or (Cin * es) % 4 or (Cout * es) % 4
            or feat.data_ptr() % 4 or w.data_ptr() % 4
            or not (feat.is_contiguous() and rb.is_contiguous()
                    and w.is_contiguous())):
        raise ValueError(
            "rulebook_conv: need contiguous feat [rows, Cin] fp32/bf16, rb "
            f"[K, B, Vout] int32, w [K, Cin, Cout<={MAX_COUT}] ([K, Cout, "
            "Cin] with w_t) of feat's dtype, rows and data of a multiple "
            "of 4 bytes, "
            f"miss in (rows - 1, rows); got {feat.dtype} "
            f"{tuple(feat.shape)}, {rb.dtype} {tuple(rb.shape)}, {w.dtype} "
            f"{tuple(w.shape)}, w_t={w_t}, miss={miss}")
    M = B * Vout
    Mout = M + int(zero_row)
    out = torch.empty(Mout, Cout, dtype=feat.dtype, device=feat.device)
    if out.numel() == 0:
        return out if zero_row else out.reshape(B, Vout, Cout)
    nsplit = conv_splits(K, Cin)
    part = flags = None
    if nsplit > 1:
        part = torch.empty(nsplit, Mout, Cout, dtype=torch.float32,
                           device=feat.device)
        flags = torch.empty(nsplit, -(-Mout // CONV_TILE_M),
                            dtype=torch.int32, device=feat.device)
    lib = cuda_build.load("rulebook_conv", _SIG)
    err = lib.rulebook_conv(
        feat.data_ptr(), rb.data_ptr(), w.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(),
        None if flags is None else flags.data_ptr(), K, M, Mout, Cin, Cout,
        miss, nsplit, int(flip_taps), int(w_t),
        int(feat.dtype == torch.bfloat16), cuda_build.stream_of(feat))
    cuda_build.check(err, "rulebook_conv")
    rulebook_conv.launches += 1
    return out if zero_row else out.reshape(B, Vout, Cout)


rulebook_conv.launches = 0


def dw_tiling(K, Cin, Cout):
    """The dW kernel's tile (rulebook_conv_dw.cu ``launch`` picks the same):
    (Cin tile, Cout tile, tap groups). A block holds as many taps as its
    accumulators allow at that tile with four blocks an SM."""
    cit, cot, taps = ((16, 32, 7) if Cin <= 16 else
                      (32, 32, 4) if Cout <= 32 else
                      (32, 64, 4) if Cin <= 32 else (64, 64, 2))
    per_group = -(-K // -(-K // taps))
    return cit, cot, -(-K // per_group)


def dw_splits(K, M, Cin, Cout):
    """How many row ranges the dW kernel cuts M into, so that its grid
    (ranges x tap groups x Cin and Cout tiles) fills the card; range s
    holds the DW_TILE_M-row tiles s, s + nsplit, s + 2 nsplit, ..."""
    cit, cot, groups = dw_tiling(K, Cin, Cout)
    blocks = groups * -(-Cin // cit) * -(-Cout // cot)
    tiles = -(-M // DW_TILE_M)
    return max(1, min(tiles, -(-DW_TARGET_BLOCKS // blocks)))


def rulebook_conv_dw(feat, rb, gout):
    """Weight gradient of the rulebook conv, the contract of
    ``rulebook_conv_dw_plain``: [K, Cin, Cout] fp32. CPU tensors take the
    plain version; CUDA tensors launch the kernel (fp32 or bf16 inputs,
    fp32 accumulation and output; Cin and Cout times the element size
    multiples of 4 bytes). One call counts as one launch: the partial-sum
    kernel plus, when M is split, its reduction."""
    if feat.device.type == "cpu":
        return rulebook_conv_dw_plain(feat, rb, gout)
    _check_cuda("rulebook_conv_dw", feat, rb, gout)
    K, B, Vout = rb.shape
    N1, Cin = feat.shape
    M = B * Vout
    es = feat.element_size()
    if (feat.dtype not in (torch.float32, torch.bfloat16)
            or gout.dtype != feat.dtype or rb.dtype != torch.int32
            or gout.dim() != 2 or gout.shape[0] != M
            or not 0 < gout.shape[1] <= MAX_COUT
            or (Cin * es) % 4 or (gout.shape[1] * es) % 4
            or feat.data_ptr() % 4 or gout.data_ptr() % 4
            or not (feat.is_contiguous() and rb.is_contiguous()
                    and gout.is_contiguous())):
        raise ValueError(
            "rulebook_conv_dw: need contiguous feat [N+1, Cin] fp32/bf16, "
            f"rb [K, B, Vout] int32, gout [B*Vout, Cout<={MAX_COUT}] of "
            "feat's dtype, rows and data of a multiple of 4 bytes; got "
            f"{feat.dtype} {tuple(feat.shape)}, {rb.dtype} "
            f"{tuple(rb.shape)}, {gout.dtype} {tuple(gout.shape)}")
    Cout = gout.shape[1]
    if M == 0 or K == 0 or Cin == 0:
        return torch.zeros(K, Cin, Cout, dtype=torch.float32,
                           device=feat.device)
    dw = torch.empty(K, Cin, Cout, dtype=torch.float32, device=feat.device)
    nsplit = dw_splits(K, M, Cin, Cout)
    part = dw if nsplit == 1 else torch.empty(
        nsplit, K, Cin, Cout, dtype=torch.float32, device=feat.device)
    lib = cuda_build.load("rulebook_conv_dw", _SIG_DW)
    err = lib.rulebook_conv_dw(
        feat.data_ptr(), rb.data_ptr(), gout.data_ptr(), part.data_ptr(),
        dw.data_ptr(), K, M, Cin, Cout, N1 - 1, nsplit,
        int(feat.dtype == torch.bfloat16), cuda_build.stream_of(feat))
    cuda_build.check(err, "rulebook_conv_dw")
    rulebook_conv_dw.launches += 1
    return dw


rulebook_conv_dw.launches = 0


class RulebookConvFn(torch.autograd.Function):
    """``rulebook_conv`` with the backward of the JAX package's fused conv
    (sparse_pallas.py conv_bwd). Only (feat, w, rb, rb_t) are saved, no
    gathered rows: dW re-gathers.

    rb_t is the transposed rulebook [K, B, Vin] (miss = B*Vout): the
    paired rulebook of a strided or inverse conv, or None for a
    submanifold conv, whose transpose is its own rulebook with the taps
    mirrored (Vin == Vout).

    dX is the forward kernel on the output cotangent under rb_t with
    W[k]^T, told to mirror the taps of a subm rulebook (``flip_taps``),
    to read w transposed (``w_t``), that the miss index is the
    cotangent's row count (``miss``) and to append the zero row of the
    flat gradient (``zero_row``): no rulebook, weight or cotangent copy.
    dW is the dW kernel. A conv whose input needs no gradient launches no
    dX."""

    @staticmethod
    def forward(ctx, feat, w, rb, rb_t):
        ctx.save_for_backward(feat, w, rb, rb_t)
        return rulebook_conv(feat, rb, w)

    @staticmethod
    def backward(ctx, gout):
        with span("sparse_conv"):
            feat, w, rb, rb_t = ctx.saved_tensors
            K, B, Vout = rb.shape
            g_rows = gout.reshape(B * Vout, -1).contiguous()
            dfeat = dw = None
            if ctx.needs_input_grad[0]:
                flip = rb_t is None
                if flip:
                    if B * Vout != feat.shape[0] - 1:
                        raise ValueError("a rulebook without its transpose "
                                         "must be submanifold (Vin == Vout)")
                    rb_t = rb
                # the kernel mirrors the taps and reads w[k]^T in place,
                # takes the miss index B*Vout as zeros, and writes dfeat's
                # zero row
                dfeat = rulebook_conv(g_rows, rb_t, w, flip_taps=flip,
                                      w_t=True, miss=B * Vout, zero_row=True)
            if ctx.needs_input_grad[1]:
                dw = rulebook_conv_dw(feat, rb, g_rows).to(w.dtype)
            return dfeat, dw, None, None
