"""Fused gather -> GEMM rulebook sparse convolution (forward).

Counterpart of lidarseg3d_tpu/ops/pallas_conv.py::rulebook_conv_block as
wired by lidarseg3d_tpu/ops/sparse_pallas.py::fused_conv, at the JAX
package's public layout:

    feat [B*Vin + 1, Cin]  (``flat_features``: last row all zeros)
    rb   [K, B, Vout] int32 global flat rows, a miss is B*Vin
    w    [K, Cin, Cout]
    ->   [B, Vout, Cout]

The kernel is ``csrc/rulebook_conv.cu``. ``rulebook_conv_plain`` is
lidarseg3d_tpu/ops/sparse.py::_gather_gemm_core in PyTorch: index_select,
matmul, then a sum over taps, accumulated in fp32.
"""

import ctypes

import torch

from . import cuda_build

_SIG = {"rulebook_conv": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
        + [ctypes.c_void_p]}
MAX_COUT = 128


def rulebook_conv_plain(feat, rb, w):
    K, B, Vout = rb.shape
    acc = torch.zeros(B * Vout, w.shape[2], dtype=torch.float32,
                      device=feat.device)
    for k in range(K):
        g = feat.index_select(0, rb[k].reshape(-1).to(torch.int64))
        acc += g.float() @ w[k].float()
    return acc.reshape(B, Vout, -1).to(feat.dtype)


def rulebook_conv(feat, rb, w):
    """Same contract as ``rulebook_conv_plain``. CPU tensors take the plain
    version; CUDA tensors launch the kernel (fp32 or bf16 inputs, fp32
    accumulation, output in the input dtype)."""
    if feat.device.type == "cpu":
        return rulebook_conv_plain(feat, rb, w)
    if feat.device.type != "cuda" or rb.device != feat.device \
            or w.device != feat.device:
        raise ValueError("rulebook_conv: feat, rb and w must share one CUDA "
                         f"device; got {feat.device}, {rb.device}, {w.device}")
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
