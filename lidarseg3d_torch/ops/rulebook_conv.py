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
transposed rulebook) and ``csrc/rulebook_conv_dw.cu`` (dW).
``rulebook_conv_plain`` is lidarseg3d_tpu/ops/sparse.py::_gather_gemm_core
in PyTorch: index_select, matmul, then a sum over taps;
``rulebook_conv_dw_plain`` is its weight gradient written the same way.
Both accumulate in ``promote_types(dtype, float32)``.
"""

import ctypes

import torch

from . import cuda_build

_SIG = {"rulebook_conv": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
        + [ctypes.c_void_p]}
_SIG_DW = {"rulebook_conv_dw": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
           + [ctypes.c_void_p]}
MAX_COUT = 1024  # forward kernel: 128 columns per blockIdx.y
MAX_COUT_DW = 128  # dW kernel: one column tile
DW_TILE_M = 32  # rows of one dW tile (kTileM in rulebook_conv_dw.cu)
DW_TARGET_BLOCKS = 1056  # 8 blocks for each of the H100's 132 SMs


def _acc_dtype(dtype):
    return torch.promote_types(dtype, torch.float32)


def rulebook_conv_plain(feat, rb, w):
    K, B, Vout = rb.shape
    acc_t = _acc_dtype(feat.dtype)
    acc = torch.zeros(B * Vout, w.shape[2], dtype=acc_t, device=feat.device)
    for k in range(K):
        g = feat.index_select(0, rb[k].reshape(-1).to(torch.int64))
        acc += g.to(acc_t) @ w[k].to(acc_t)
    return acc.reshape(B, Vout, -1).to(feat.dtype)


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


def rulebook_conv(feat, rb, w):
    """Same contract as ``rulebook_conv_plain``. CPU tensors take the plain
    version; CUDA tensors launch the kernel (fp32 or bf16 inputs, fp32
    accumulation, output in the input dtype)."""
    if feat.device.type == "cpu":
        return rulebook_conv_plain(feat, rb, w)
    _check_cuda("rulebook_conv", feat, rb, w)
    K, B, Vout = rb.shape
    N1, Cin = feat.shape
    if (feat.dtype not in (torch.float32, torch.bfloat16)
            or w.dtype != feat.dtype or rb.dtype != torch.int32
            or tuple(w.shape[:2]) != (K, Cin) or not 0 < w.shape[2] <= MAX_COUT
            or not (feat.is_contiguous() and rb.is_contiguous()
                    and w.is_contiguous())):
        raise ValueError(
            "rulebook_conv: need contiguous feat [N+1, Cin] fp32/bf16, rb "
            f"[K, B, Vout] int32, w [K, Cin, Cout<={MAX_COUT}] of feat's "
            f"dtype; got {feat.dtype} {tuple(feat.shape)}, {rb.dtype} "
            f"{tuple(rb.shape)}, {w.dtype} {tuple(w.shape)}")
    Cout = w.shape[2]
    out = torch.empty(B, Vout, Cout, dtype=feat.dtype, device=feat.device)
    if out.numel() == 0:
        return out
    lib = cuda_build.load("rulebook_conv", _SIG)
    err = lib.rulebook_conv(
        feat.data_ptr(), rb.data_ptr(), w.data_ptr(), out.data_ptr(), K,
        B * Vout, Cin, Cout, N1 - 1, int(feat.dtype == torch.bfloat16),
        cuda_build.stream_of(feat))
    cuda_build.check(err, "rulebook_conv")
    rulebook_conv.launches += 1
    return out


rulebook_conv.launches = 0


def dw_splits(K, M, Cin):
    """How many row ranges the dW kernel cuts M into, so that its grid
    (taps x Cin chunks x ranges) fills the card; each range is a whole
    number of tiles."""
    ci = 16 if Cin <= 16 else 32 if Cin <= 32 else 64
    chunks = -(-Cin // ci)
    tiles = -(-M // DW_TILE_M)
    return max(1, min(tiles, -(-DW_TARGET_BLOCKS // (K * chunks))))


def rulebook_conv_dw(feat, rb, gout):
    """Weight gradient of the rulebook conv, the contract of
    ``rulebook_conv_dw_plain``: [K, Cin, Cout] fp32. CPU tensors take the
    plain version; CUDA tensors launch the kernel (fp32 or bf16 inputs,
    fp32 accumulation and output). One call counts as one launch: the
    partial-sum kernel plus, when M is split, its reduction."""
    if feat.device.type == "cpu":
        return rulebook_conv_dw_plain(feat, rb, gout)
    _check_cuda("rulebook_conv_dw", feat, rb, gout)
    K, B, Vout = rb.shape
    N1, Cin = feat.shape
    M = B * Vout
    if (feat.dtype not in (torch.float32, torch.bfloat16)
            or gout.dtype != feat.dtype or rb.dtype != torch.int32
            or gout.dim() != 2 or gout.shape[0] != M
            or not 0 < gout.shape[1] <= MAX_COUT_DW
            or not (feat.is_contiguous() and rb.is_contiguous()
                    and gout.is_contiguous())):
        raise ValueError(
            "rulebook_conv_dw: need contiguous feat [N+1, Cin] fp32/bf16, "
            f"rb [K, B, Vout] int32, gout [B*Vout, Cout<={MAX_COUT_DW}] of "
            f"feat's dtype; got {feat.dtype} {tuple(feat.shape)}, {rb.dtype} "
            f"{tuple(rb.shape)}, {gout.dtype} {tuple(gout.shape)}")
    Cout = gout.shape[1]
    if M == 0 or K == 0 or Cin == 0:
        return torch.zeros(K, Cin, Cout, dtype=torch.float32,
                           device=feat.device)
    dw = torch.empty(K, Cin, Cout, dtype=torch.float32, device=feat.device)
    nsplit = dw_splits(K, M, Cin)
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
    W[k]^T; dW is the dW kernel. A conv whose input needs no gradient
    launches no dX."""

    @staticmethod
    def forward(ctx, feat, w, rb, rb_t):
        ctx.save_for_backward(feat, w, rb, rb_t)
        return rulebook_conv(feat, rb, w)

    @staticmethod
    def backward(ctx, gout):
        feat, w, rb, rb_t = ctx.saved_tensors
        K, B, Vout = rb.shape
        g_rows = gout.reshape(B * Vout, -1).contiguous()
        dfeat = dw = None
        if ctx.needs_input_grad[0]:
            if rb_t is None:
                if B * Vout != feat.shape[0] - 1:
                    raise ValueError("a rulebook without its transpose "
                                     "must be submanifold (Vin == Vout)")
                rb_t = rb.flip(0)
            dx = rulebook_conv(
                torch.cat([g_rows, g_rows.new_zeros(1, g_rows.shape[1])]),
                rb_t.contiguous(), w.transpose(1, 2).contiguous())
            dfeat = torch.cat([dx.reshape(-1, dx.shape[-1]),
                               dx.new_zeros(1, dx.shape[-1])])
        if ctx.needs_input_grad[1]:
            dw = rulebook_conv_dw(feat, rb, g_rows).to(w.dtype)
        return dfeat, dw, None, None
