"""``MaskedBatchNorm`` in training mode on 2 gloo ranks (CPU) equals one
process on the concatenation of the ranks' rows: the output, the input
gradient, the scale and bias gradients (summed over the ranks) and the
running statistics (identical on both ranks), within 1e-5 of the largest
entry. The ranks hold unequal numbers of valid entries, or one rank holds
none; also without a mask (every entry) and on the channel dim 1 of NCHW
maps (the image branch's layout). Each rank back-propagates its share of
the global loss."""

import numpy as np
import pytest
import torch

from lidarseg3d_torch.models.layers import MaskedBatchNorm

from _torch_ddp import bn_step, run_ranks

REL = 1e-5
C = 6


def _case(kind):
    rng = np.random.default_rng({"unequal": 0, "one_empty": 1,
                                 "no_mask": 2, "nchw": 3}[kind])
    nchw = kind == "nchw"
    shapes = [(2, C, 3, 4), (2, C, 3, 4)] if nchw else [(9, C), (5, C)]
    x = [torch.from_numpy(rng.normal(1.5, 2.0, s).astype(np.float32))
         for s in shapes]
    w = [torch.from_numpy(rng.normal(0, 1, s).astype(np.float32))
         for s in shapes]
    mask = None
    if kind == "unequal":
        mask = [torch.tensor([1, 0, 1, 1, 1, 0, 1, 0, 1], dtype=torch.bool),
                torch.tensor([0, 1, 1, 0, 0], dtype=torch.bool)]
    elif kind == "one_empty":
        mask = [torch.tensor([1, 1, 0, 1, 1, 1, 0, 1, 1], dtype=torch.bool),
                torch.zeros(5, dtype=torch.bool)]
    bn = MaskedBatchNorm(C, eps=1e-5, channel_dim=1 if nchw else -1)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, C)))
        bn.bias.copy_(torch.from_numpy(rng.normal(0, 0.2, C)))
        bn.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.2, C)))
        bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, C)))
    return dict(C=C, eps=1e-5, channel_dim=bn.channel_dim, x=x, w=w,
                mask=mask, state=bn.state_dict())


def _one_process(case):
    bn = MaskedBatchNorm(C, eps=case["eps"], channel_dim=case["channel_dim"])
    bn.load_state_dict(case["state"])
    bn.train()
    x = torch.cat(case["x"]).requires_grad_(True)
    mask = None if case["mask"] is None else torch.cat(case["mask"])
    y = bn(x, mask=mask)
    (y * torch.cat(case["w"])).sum().backward()
    return dict(y=y.detach(), dx=x.grad, dweight=bn.weight.grad,
                dbias=bn.bias.grad, running_mean=bn.running_mean,
                running_var=bn.running_var)


def _close(got, want, what):
    scale = max(float(want.abs().max()), 1e-30)
    err = float((got - want).abs().max())
    assert err <= REL * scale, f"{what}: {err} > {REL} * {scale}"


@pytest.mark.parametrize("kind", ["unequal", "one_empty", "no_mask", "nchw"])
def test_two_ranks_equal_one_process(kind, tmp_path):
    case = _case(kind)
    want = _one_process(case)
    ranks = run_ranks(bn_step, 2, tmp_path, case)
    n0 = case["x"][0].shape[0]
    _close(torch.cat([r["y"] for r in ranks]), want["y"], "output")
    _close(torch.cat([r["dx"] for r in ranks]), want["dx"], "input grad")
    for k in ("dweight", "dbias"):
        _close(ranks[0][k] + ranks[1][k], want[k], k)
    for k in ("running_mean", "running_var"):
        assert torch.equal(ranks[0][k], ranks[1][k]), k
        _close(ranks[0][k], want[k], k)
    assert torch.isfinite(ranks[1]["y"]).all() and n0 > 0
