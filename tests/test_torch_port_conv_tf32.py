"""The numerics of the conv kernels' fp32 path, emulated on the CPU.

csrc/rulebook_conv.cu (forward and dX) and csrc/rulebook_conv_dw.cu (dW)
run fp32 on the tensor cores as 3xTF32 (csrc/tensor_core.cuh): each
operand x splits into hi = tf32_rna(x) and lo = tf32_rna(x - hi), where
tf32_rna rounds to 10 mantissa bits, to nearest with ties away from zero
(``cvt.rna.tf32.f32``), and a product is lo_a*hi_b + hi_a*lo_b + hi_a*hi_b
accumulated in fp32. Products of tf32 values are exact in fp32, so the
fp32 matmuls below compute what the MMAs compute, up to the order of the
sums.

These tests hold the emulation to chip_smoke.py's limits on the card,
TOL_CONV["fp32"] and TOL_DW["fp32"] (max |err| <= 1e-5 * max |plain|,
against the plain fp32 conv and dW), at scaled-down copies of its phase-4
shapes (the widths kept, the rows cut), at K*Cin = 27*256, and for a dW sum
over 65,536 rows; and show that one TF32 product, the card's default for
fp32 matmuls that the port switches off, misses the same limit. The inputs
are drawn as chip_smoke.py draws them: features U[0, 1), weights
U(-1, 1) / sqrt(K*Cin), cotangents U(-1, 1)."""

import numpy as np
import pytest
import torch

from lidarseg3d_torch.ops.rulebook_conv import (rulebook_conv_dw_plain,
                                                rulebook_conv_plain)

from test_torch_port_support import one_torch_thread  # noqa: F401

TOL = 1e-5  # chip_smoke.py TOL_CONV["fp32"] and TOL_DW["fp32"]
K = 27


def tf32_rna(x):
    """Round fp32 to tf32 (10 mantissa bits), to nearest, ties away from
    zero, as cvt.rna.tf32.f32: add half a tf32 ulp to the magnitude bits
    and clear the 13 low bits; inf and NaN pass unchanged."""
    bits = x.contiguous().view(torch.int32)
    special = (bits & 0x7F800000) == 0x7F800000
    rounded = (bits + 0x1000) & -0x2000
    return torch.where(special, bits, rounded).view(torch.float32)


def _split(x):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def mm_3xtf32(a, b):
    (ah, al), (bh, bl) = _split(a), _split(b)
    return al @ bh + ah @ bl + ah @ bh


def mm_1xtf32(a, b):
    return tf32_rna(a) @ tf32_rna(b)


def _conv(feat, rb, w, mm):
    """rulebook_conv_plain with its products taken by ``mm``."""
    acc = torch.zeros(rb.shape[1] * rb.shape[2], w.shape[2])
    for k in range(rb.shape[0]):
        acc += mm(feat.index_select(0, rb[k].reshape(-1).long()), w[k])
    return acc


def _dw(feat, rb, g, mm):
    return torch.stack([mm(feat.index_select(0, rb[k].reshape(-1).long()).T,
                           g) for k in range(rb.shape[0])])


def _rel_err(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _inputs(rows, cin, cout, M, p, seed, taps=K):
    rng = np.random.default_rng(seed)
    feat = np.concatenate([rng.uniform(0, 1, (rows, cin)),
                           np.zeros((1, cin))]).astype(np.float32)
    w = (rng.uniform(-1, 1, (taps, cin, cout))
         / np.sqrt(taps * cin)).astype(np.float32)
    idx = rng.integers(0, rows, (taps, 1, M))
    rb = np.where(rng.random((taps, 1, M)) < p, idx, rows).astype(np.int32)
    g = rng.uniform(-1, 1, (M, cout)).astype(np.float32)
    return (torch.from_numpy(feat), torch.from_numpy(rb),
            torch.from_numpy(w), torch.from_numpy(g))


def _bits(v):
    return torch.tensor([v], dtype=torch.int64).to(torch.int32).view(
        torch.float32)


@pytest.mark.parametrize("src,want", [
    (0x3F800000, 0x3F800000),  # 1.0 is tf32
    (0x3F800FFF, 0x3F800000),  # below the tie: down
    (0x3F801000, 0x3F802000),  # 1 + 2^-11, a tie: away (ties-to-even: 1.0)
    (0xBF801000, 0xBF802000),  # the negative tie: away from zero
    (0x3F803000, 0x3F804000),  # a tie from an odd tf32 value
    (0x3F802FFF, 0x3F802000),
    (0x00001000, 0x00002000),  # subnormal tie: up to the tf32 subnormal
    (0x00000FFF, 0x00000000),  # below half the tf32 subnormal: zero
    (0x80001000, 0x80002000),  # negative subnormal tie
    (0x007FF000, 0x00800000),  # largest subnormal tie: the least normal
    (0x00000000, 0x00000000),
    (0x80000000, 0x80000000),  # -0 keeps its sign
    (0x7F800000, 0x7F800000),  # +inf unchanged
    (0xFF800000, 0xFF800000),  # -inf unchanged
], ids=lambda v: f"{v:08x}")
def test_tf32_rna_hand_picked(src, want):
    got = tf32_rna(_bits(src)).view(torch.int32)
    assert int(got) & 0xFFFFFFFF == want


def test_tf32_rna_nan_and_random_values():
    assert torch.isnan(tf32_rna(torch.tensor([float("nan")]))).all()
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=100_000).astype(np.float32))
    r = tf32_rna(x)
    assert not (r.view(torch.int32) & 0x1FFF).any()  # 10 mantissa bits
    assert ((r - x).abs() <= x.abs() * 2.0 ** -11).all()  # half an ulp
    hi, lo = _split(x)
    # hi + lo carries 21-22 significant bits: within 2^-21 of x
    assert ((hi + lo - x).abs() <= x.abs() * 2.0 ** -21).all()


# chip_smoke.py phase 4, cut to a few thousand rows: (Cin, Cout, M, hit
# probability, forward or dX), with K*Cin = 27*256 among them
CONV_SHAPES = [
    (12, 32, 4096, 0.3, "fwd"),  # stage-1 subm, the input conv
    (32, 64, 4096, 0.3, "fwd"),  # stage-1 -> 2 strided
    (256, 128, 1024, 0.75, "fwd"),  # stage-4 subm of the concat, 27*256
    (32, 32, 4096, 0.3, "dX"),  # dX of stage-1 subm 32->32
    (64, 32, 4096, 0.3, "dX"),  # dX of strided 32->64
    (128, 256, 1024, 0.75, "dX"),  # dX of stage-4 subm 256->128
]


@pytest.mark.parametrize("cin,cout,M,p,kind", CONV_SHAPES,
                         ids=[f"{k}-{a}x{b}" for a, b, _, _, k in
                              CONV_SHAPES])
def test_conv_3xtf32_holds_fp32_tolerance(cin, cout, M, p, kind):
    feat, rb, w, _ = _inputs(M, cin, cout, M, p, seed=cin + cout)
    if kind == "dX":  # the kernel's dX operands: w read transposed
        wt = w.transpose(1, 2).contiguous()
        want = rulebook_conv_plain(feat, rb, wt, flip_taps=True, w_t=True)
        rb = rb.flip(0)
    else:
        want = rulebook_conv_plain(feat, rb, w)
    want = want.reshape(M, cout)
    assert _rel_err(_conv(feat, rb, w, mm_3xtf32), want) <= TOL
    assert _rel_err(_conv(feat, rb, w, mm_1xtf32), want) > TOL


DW_SHAPES = [
    (12, 32, 4096, 0.3, K),  # stage-1 subm 12->32
    (32, 64, 4096, 0.3, K),  # strided 32->64
    (256, 128, 1024, 0.75, K),  # stage-4 subm 256->128
    (128, 128, 2048, 0.5, K),  # inverse 128->128
    (32, 32, 65536, 0.3, 3),  # a sum over 65,536 rows (three taps)
]


@pytest.mark.parametrize("cin,cout,M,p,taps", DW_SHAPES,
                         ids=[f"{a}x{b}-M{m}" for a, b, m, _, _ in
                              DW_SHAPES])
def test_dw_3xtf32_holds_fp32_tolerance(cin, cout, M, p, taps):
    feat, rb, _, g = _inputs(M, cin, cout, M, p, seed=cin * cout,
                             taps=taps)
    want = rulebook_conv_dw_plain(feat, rb, g)
    assert _rel_err(_dw(feat, rb, g, mm_3xtf32), want) <= TOL
    assert _rel_err(_dw(feat, rb, g, mm_1xtf32), want) > TOL


def test_train_step_gradients_move_no_more_than_an_fp32_reordering(
        monkeypatch):
    """chip_smoke.py's small train step on the CPU three times: with the
    plain fp32 convs, with every fp32 conv, dX and dW product taken as
    3xTF32 (fp32 sums), and with plain fp32 products whose reduction is
    summed in two halves (another order, as any kernel has). Over the
    lidar branch's and the head's gradients (chip_smoke's floor for
    tensors whose gradient is analytically zero), the worst relative L2
    change of 3xTF32 stays within 1.5x that of the reordering: the split
    costs no more than fp32's own order noise. That noise is above 1e-3
    for BN biases whose gradient nearly cancels (the next BN removes the
    mean), the limit the card is held to against the CPU."""
    import chip_smoke as cs
    from lidarseg3d_torch import synthetic as syn
    from lidarseg3d_torch.apis import train as tr
    from lidarseg3d_torch.models import build_detector
    from lidarseg3d_torch.ops import rulebook_conv as rc

    def halves(a, b):
        h = a.shape[1] // 2
        return a[:, :h] @ b[:h] + a[:, h:] @ b[h:]

    def make(mm):
        def conv(feat, rb, w, flip_taps=False, w_t=False, miss=None,
                 zero_row=False):
            K, B, Vout = rb.shape
            if miss is not None and miss == feat.shape[0]:
                feat = torch.cat([feat, feat.new_zeros(1, feat.shape[1])])
            M = B * Vout
            acc = torch.zeros(M + int(zero_row), w.shape[1 if w_t else 2])
            for k in range(K):
                g = feat.index_select(
                    0, rb[K - 1 - k if flip_taps else k].reshape(-1).long())
                acc[:M] += mm(g, (w[k].T if w_t else w[k]).contiguous())
            return acc if zero_row else acc.reshape(B, Vout, -1)

        def dw(feat, rb, gout):
            return torch.stack([mm(
                feat.index_select(0, rb[k].reshape(-1).long()).T.contiguous(),
                gout) for k in range(rb.shape[0])])
        return conv, dw

    cfg = syn.mseg3d_model_cfg(ratio=1, small_hrnet=True)
    cfg["point_head"]["model_cfg"]["DP_RATIO"] = 0
    batch = syn.synthetic_mseg3d_batch(2, 4096, 4096, img_hw=(64, 128),
                                       seed=7, with_labels=True)
    # one thread: beside other test workers, three train steps on every
    # core thrash (minutes instead of seconds)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    runs = {}
    try:
        for name, fns in (("fp32", (rc.rulebook_conv_plain,
                                    rc.rulebook_conv_dw_plain)),
                          ("3xtf32", make(mm_3xtf32)),
                          ("halves", make(halves))):
            monkeypatch.setattr(rc, "rulebook_conv_plain", fns[0])
            monkeypatch.setattr(rc, "rulebook_conv_dw_plain", fns[1])
            model = build_detector(cfg, device="cpu", seed=3)
            _, state, step = cs.train_setup(
                model, dict(type="adam", wd=0.01), dict(lr_max=2e-3), 12,
                35.0, syn.grid_shape())
            _, losses = step(state, tr.example_to_device(batch, "cpu"))
            runs[name] = (float(losses["grad_norm"]),
                          {k: p.grad.detach().clone()
                           for k, p in model.named_parameters()
                           if not k.startswith("img_")})
    finally:
        torch.set_num_threads(threads)
    floor = 1e-8 * runs["fp32"][0]

    def worst(name):
        return max(
            (float((runs[name][1][k] - want).norm() / want.norm()), k)
            for k, want in runs["fp32"][1].items()
            if float(want.abs().max()) > 10 * floor)

    split, order = worst("3xtf32"), worst("halves")
    print("worst relative L2: 3xTF32", split, "fp32 in two halves", order)
    assert split[0] <= 1.5 * order[0]
