"""lidarseg3d_torch's optimizer, loss and layers against the float64
fastai oracle of tests/_train_parity_body.py (a torch stack independent of
both packages, copied into tests/_torch_port_oracles.py), over 20 steps:

the same tiny head (Linear without bias -> BN(eps 1e-3, momentum 0.01)
-> ReLU -> Linear, the reference's make_convcls_head shape) from the same
initial state on the same three seeded batches (every 17th row ignored),
run in float64 by the port's ``TorchLinear``, ``MaskedBatchNorm`` (batch
statistics), ``ops.losses.cross_entropy`` and ``solver.optim``'s
``build_one_cycle_optimizer`` (``ChainedAdam``: global-norm clip 35,
decoupled decay 0.01 of every parameter, BN included, Adam with OneCycle
lr and beta1 read each step). The losses, the final parameters and the BN
running statistics agree within rtol 1e-6 and atol 1e-9, the limit the
JAX package's losses are held to (tests/test_train_parity.py), and the
loss falls. Torch runs on one thread, so the sums' order is fixed."""

import numpy as np
import torch

from lidarseg3d_torch.models.layers import MaskedBatchNorm, TorchLinear
from lidarseg3d_torch.ops.losses import cross_entropy
from lidarseg3d_torch.solver.optim import build_one_cycle_optimizer

import _torch_port_oracles as o
from test_torch_port_support import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-6, 1e-9


def port_head(init):
    head = torch.nn.Sequential(
        TorchLinear(o.F, o.H, bias=False),
        MaskedBatchNorm(o.H, eps=o.BN_EPS, momentum=o.BN_MOM),
        torch.nn.ReLU(),
        TorchLinear(o.H, o.C, bias=True),
    ).double()
    head.load_state_dict({k: torch.tensor(v) for k, v in init.items()
                          if not k.endswith("num_batches_tracked")})
    return head.train()


def test_train_dynamics_match_the_fastai_oracle_20_steps():
    xs, ys = o.parity_batches()
    init, want_losses, want = o.fastai_head_oracle(xs, ys)
    head = port_head(init)
    tx, lr_fn = build_one_cycle_optimizer(
        dict(type="adam", wd=o.WD, fixed_wd=True),
        dict(lr_max=o.LR_MAX, moms=list(o.MOMS), div_factor=o.DIV,
             pct_start=o.PCT), total_steps=o.STEPS, grad_clip=o.CLIP)
    params = list(head.parameters())
    state = tx.init(params)
    losses = []
    for t in range(o.STEPS):
        assert abs(lr_fn(t) - o.one_cycle_np(t, o.STEPS)[0]) <= 1e-15
        head.zero_grad(set_to_none=True)
        loss = cross_entropy(head(torch.tensor(xs[t % 3])),
                             torch.tensor(ys[t % 3]), ignore_index=0)
        loss.backward()
        tx.update(params, [p.grad for p in params], state)
        losses.append(loss.item())
    losses = np.asarray(losses)
    np.testing.assert_allclose(losses, want_losses, rtol=RTOL, atol=ATOL,
                               err_msg="loss trajectory")
    assert losses[-1] < losses[0]
    got = head.state_dict()
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        assert got[k].dtype == torch.float64, k
        np.testing.assert_allclose(got[k].numpy(), v, rtol=RTOL, atol=ATOL,
                                   err_msg=k)
        assert not np.array_equal(v, init[k]), k  # every tensor moved
