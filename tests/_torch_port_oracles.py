"""Oracles independent of both packages, for the tests that hold
lidarseg3d_torch against them (tests/test_torch_port_golden_*.py,
test_torch_port_train_dynamics.py). Each is a copy of an oracle that a
JAX test keeps inside a test body or behind a module-level assert, so it
cannot be imported from there:

- ``unet_train_oracle``: the float64 dense-conv UNetSCN3D of
  tests/test_golden_unet.py (``test_unet_matches_torch_dense_oracle``'s
  body) in training mode (batch statistics over the active sites), on its
  helpers;
- ``exact_three_nn``: lidarseg3d_tpu/ops/interpolate.py:337's brute-force
  k nearest neighbours, in numpy float64;
- ``fastai_head_oracle``: tests/_train_parity_body.py's float64 torch
  head trained with fastai's OptimWrapper semantics (clip 35, decoupled
  decay of every parameter, Adam with per-step OneCycle lr and beta1, BN
  momentum 0.01), and its ``one_cycle_np`` schedule."""

import numpy as np
import torch

from test_golden_unet import t_basic_block, t_conv_bn_relu, union_mask


def unet_train_oracle(dense_np, act, P, R=1):
    """UNetSCN3D forward in training mode on a dense float64 grid.
    dense_np [1, Z, Y, X, C] input features, act [n, 3] active (z, y, x)
    sites, P the backbone's Flax params (nn.scan stacks on a leading
    axis) -> {x_conv4, x_up4, x_up3, x_up2, x_up1} dense [1, C, Z, Y, X]
    volumes, zero off their site sets."""
    x0 = torch.tensor(dense_np.transpose(0, 4, 1, 2, 3), dtype=torch.float64)
    m1 = torch.zeros((1, 1) + tuple(dense_np.shape[1:4]),
                     dtype=torch.float64)
    m1[0, 0, act[:, 0], act[:, 1], act[:, 2]] = 1.0
    m2 = union_mask(m1, (3, 3, 3), (2, 2, 2), (1, 1, 1))
    m3 = union_mask(m2, (3, 3, 3), (2, 2, 2), (1, 1, 1))
    m4 = union_mask(m3, (3, 3, 3), (2, 2, 2), (0, 1, 1))

    def cbr(i):
        return P[f"SparseConvBNReLU_{i}"]

    def enc_blk(stage, j):
        sub = P[f"SparseBasicBlockStack_{stage}"]["blocks"][
            "SparseBasicBlock_0"]
        return {k: {kk: np.asarray(vv)[j] for kk, vv in v.items()}
                for k, v in sub.items()}

    x = t_conv_bn_relu(x0, m1, cbr(0), "subm")
    xc1 = t_basic_block(x, m1, enc_blk(0, 0))
    xc1 = t_basic_block(xc1, m1, enc_blk(0, 1))
    x = t_conv_bn_relu(xc1, m2, cbr(1), "spconv", (2, 2, 2), (1, 1, 1))
    xc2 = t_basic_block(x, m2, enc_blk(1, 0))
    xc2 = t_basic_block(xc2, m2, enc_blk(1, 1))
    x = t_conv_bn_relu(xc2, m3, cbr(2), "spconv", (2, 2, 2), (1, 1, 1))
    xc3 = t_basic_block(x, m3, enc_blk(2, 0))
    xc3 = t_basic_block(xc3, m3, enc_blk(2, 1))
    x = t_conv_bn_relu(xc3, m4, cbr(3), "spconv", (2, 2, 2), (0, 1, 1))
    xc4 = t_basic_block(x, m4, enc_blk(3, 0))
    xc4 = t_basic_block(xc4, m4, enc_blk(3, 1))

    def ur(x_lat, x_bot, mask, pblk, pmid, c_mid):
        xt = t_basic_block(x_lat, mask, pblk)
        cat = torch.cat([x_bot, xt], dim=1)
        xm = t_conv_bn_relu(cat, mask, pmid, "subm")
        red = cat.view(1, c_mid, cat.shape[1] // c_mid, *cat.shape[2:]).sum(2)
        return (xm + red) * mask

    f4 = ur(xc4, xc4, m4, P["SparseBasicBlock_0"], cbr(4), 64 * R)
    up4 = t_conv_bn_relu(f4, m3, cbr(5), "inverseconv", (2, 2, 2), (0, 1, 1))
    f3 = ur(xc3, up4, m3, P["SparseBasicBlock_1"], cbr(6), 64 * R)
    up3 = t_conv_bn_relu(f3, m2, cbr(7), "inverseconv", (2, 2, 2), (1, 1, 1))
    f2 = ur(xc2, up3, m2, P["SparseBasicBlock_2"], cbr(8), 32 * R)
    up2 = t_conv_bn_relu(f2, m1, cbr(9), "inverseconv", (2, 2, 2), (1, 1, 1))
    f1 = ur(xc1, up2, m1, P["SparseBasicBlock_3"], cbr(10), 16 * R)
    up1 = t_conv_bn_relu(f1, m1, cbr(11), "subm")
    return dict(x_conv4=xc4, x_up4=up4, x_up3=up3, x_up2=up2, x_up1=up1)


def exact_three_nn(points_xyz, ref_xyz, ref_valid, k=3):
    """Brute-force k-NN by squared distance (float64): points [N, 3],
    references [V, 3] with validity [V] -> (d2 [N, k], idx [N, k]); a
    missing neighbour is (inf, V). Ties go to the lower index, as a stable
    sort of JAX's running top-k gives them."""
    p = np.asarray(points_xyz, np.float64)
    r = np.asarray(ref_xyz, np.float64)
    d2 = ((p[:, None, :] - r[None, :, :]) ** 2).sum(-1)
    d2 = np.where(np.asarray(ref_valid)[None, :], d2, np.inf)
    idx = np.argsort(d2, axis=1, kind="stable")[:, :k]
    best = np.take_along_axis(d2, idx, axis=1)
    return best, np.where(np.isfinite(best), idx, r.shape[0])


# tests/_train_parity_body.py's sizes, schedule and head
N, F, H, C = 256, 12, 32, 9
STEPS = 20
WD = 0.01
LR_MAX = 0.01
MOMS = (0.95, 0.85)
DIV, PCT = 10.0, 0.4
CLIP = 35.0
BN_EPS, BN_MOM = 1e-3, 0.01


def one_cycle_np(t, total):
    """OneCycle lr / mom at integer step t (float64): cosine from low to
    max over the first pct_start of the steps, then to low / 1e4; mom the
    other way (learning_schedules_fastai.py:77-97)."""

    def acos(a, b, pct):
        return b + (a - b) / 2.0 * (np.cos(np.pi * pct) + 1.0)

    low = LR_MAX / DIV
    split = PCT * total
    if t < split:
        lr = acos(low, LR_MAX, t / split)
        mom = acos(MOMS[0], MOMS[1], t / split)
    else:
        p = (t - split) / (total - split)
        lr = acos(LR_MAX, low / 1e4, p)
        mom = acos(MOMS[1], MOMS[0], p)
    return float(lr), float(mom)


def parity_batches():
    """The body's three seeded batches (xs [3, N, F], labels ys [3, N],
    every 17th row the ignored label 0)."""
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((3, N, F))
    w = rng.standard_normal((F,))
    ys = ((xs @ w > 0).astype(np.int64)
          + (np.abs(xs[..., 0]) > 1).astype(np.int64) * 2)
    ys[:, ::17] = 0
    return xs, ys


def fastai_head_oracle(xs, ys, seed=0):
    """The float64 torch head (torch's default init under ``seed``)
    trained STEPS steps with fastai's OptimWrapper semantics -> (its
    initial state_dict, the losses, its final state_dict), state_dicts as
    numpy."""
    with torch.random.fork_rng():
        torch.manual_seed(seed)
        tm = torch.nn.Sequential(
            torch.nn.Linear(F, H, bias=False),
            torch.nn.BatchNorm1d(H, eps=BN_EPS, momentum=BN_MOM),
            torch.nn.ReLU(),
            torch.nn.Linear(H, C, bias=True),
        ).double()
    init = {k: v.detach().clone().numpy() for k, v in tm.state_dict().items()}
    opt = torch.optim.Adam(tm.parameters(), lr=0.0, betas=(MOMS[0], 0.99),
                           eps=1e-8)
    lossf = torch.nn.CrossEntropyLoss(ignore_index=0)
    losses = []
    for t in range(STEPS):
        lr, mom = one_cycle_np(t, STEPS)
        for g in opt.param_groups:
            g["lr"] = lr
            g["betas"] = (mom, 0.99)
        x = torch.tensor(xs[t % 3])
        y = torch.tensor(ys[t % 3])
        opt.zero_grad()
        loss = lossf(tm(x), y)
        loss.backward()
        torch.nn.utils.clip_grad_norm_(tm.parameters(), CLIP)
        with torch.no_grad():  # fastai true_wd (bn_wd=True): shrink every
            for p in tm.parameters():  # parameter before the Adam step
                p.mul_(1 - WD * lr)
        opt.step()
        losses.append(loss.item())
    final = {k: v.detach().numpy() for k, v in tm.state_dict().items()}
    return init, np.asarray(losses), final
