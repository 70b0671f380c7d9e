"""Gloo ranks on the CPU for the port's multi-process tests
(tests/test_torch_port_{dist,syncbn,ddp_train,ddp_entry}.py).

``run_ranks(fn, world, tmp)`` spawns ``world`` processes; rank r starts
the process group through ``lidarseg3d_torch.parallel.dist`` (gloo, a
``file://`` rendezvous under ``tmp``, so test workers never share a port),
calls ``fn(rank, world, *args)`` and returns its result to the caller,
who gets the results in rank order. With ``start=False`` the ranks start
no group: ``fn`` does (an entry point's ``--dist_*`` flags, or torchrun's
variables), and ``rendezvous(tmp)`` is the URL to give it. A rank that
raises fails the call with its traceback. ``fn`` must be importable by a fresh process: a
module-level function of a module that imports neither JAX nor the JAX
package (this one, or one next to it)."""

import multiprocessing as mp
import os
import traceback

import torch

TIMEOUT_S = 600


def rendezvous(tmp):
    return f"file://{tmp}/rendezvous"


def _rank_main(fn, rank, world, tmp, args, start):
    out = os.path.join(tmp, f"rank{rank}.pt")
    try:
        torch.set_num_threads(1)
        from lidarseg3d_torch.parallel import dist

        if start:
            got = dist.init_distributed(rendezvous(tmp), world, rank,
                                        device="cpu")
            assert got == (rank, world), got
        try:
            result = fn(rank, world, *args)
        finally:
            dist.shutdown()
        torch.save({"result": result}, out)
    except BaseException:
        torch.save({"error": traceback.format_exc()}, out)
        raise


def run_ranks(fn, world, tmp, *args, start=True, timeout=TIMEOUT_S):
    """[fn's result on rank 0, ..., on rank world - 1]."""
    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, tmp, args, start))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join()
    results = []
    for r, p in enumerate(procs):
        path = os.path.join(tmp, f"rank{r}.pt")
        got = (torch.load(path, weights_only=False) if os.path.exists(path)
               else {"error": f"no result (exit code {p.exitcode})"})
        if "error" in got:
            raise AssertionError(f"rank {r} failed:\n{got['error']}")
        results.append(got["result"])
    return results


def collectives(rank, world):
    """parallel/dist.py's helpers on each rank (test_torch_port_dist.py)."""
    import numpy as np

    from lidarseg3d_torch.parallel import dist

    out = dict(rank=dist.rank(), world=dist.world_size(),
               main=dist.is_main_process())
    dist.barrier("collectives")
    out["hist"] = dist.allreduce_hist(np.full((3, 3), rank + 1, np.int64))
    x = torch.arange(4.0, requires_grad=True)
    y = dist.all_reduce_sum(x * (rank + 1))
    (y * (rank + 1)).sum().backward()
    out["sum"], out["sum_grad"] = y.detach(), x.grad.clone()
    rows = torch.full((2, 3), float(rank), requires_grad=True)
    g = dist.gather_rows(rows)
    (g * torch.arange(1.0, g.shape[0] + 1)[:, None]).sum().backward()
    out["gathered"], out["gather_grad"] = g.detach(), rows.grad.clone()
    out["local"] = dist.local_rows(torch.arange(2 * world))
    out["ratio"] = dist.global_ratio(torch.tensor(float(rank + 1)),
                                     torch.tensor(float(rank)))
    out["gather_main"] = dist.gather_to_main({"r": rank})
    return out


def bn_step(rank, world, case):
    """One training-mode MaskedBatchNorm forward and backward of this
    rank's rows of ``case`` (test_torch_port_syncbn.py); the loss is this
    rank's share of the global loss, so the input gradient is the global
    loss's and the parameter gradients sum over the ranks to it."""
    from lidarseg3d_torch.models.layers import MaskedBatchNorm

    bn = MaskedBatchNorm(case["C"], eps=case["eps"],
                         channel_dim=case["channel_dim"])
    bn.load_state_dict(case["state"])
    bn.train()
    x = case["x"][rank].clone().requires_grad_(True)
    mask = case["mask"][rank] if case["mask"] is not None else None
    y = bn(x, mask=mask)
    (y * case["w"][rank]).sum().backward()
    return dict(y=y.detach(), dx=x.grad, dweight=bn.weight.grad,
                dbias=bn.bias.grad, running_mean=bn.running_mean.clone(),
                running_var=bn.running_var.clone())


def record_step(model, ldict):
    """A train step's loss terms, gradients, parameters and BN statistics,
    copied."""
    return dict(losses={k: float(v) for k, v in ldict.items()},
                grads={k: p.grad.clone() for k, p in model.named_parameters()
                       if p.grad is not None},
                state={k: v.clone() for k, v in model.state_dict().items()})


def to_dtype(batch, dtype):
    """A device batch with its float tensors in ``dtype``."""
    return {k: v.to(dtype) if v.is_floating_point() else v
            for k, v in batch.items()}


def train_steps(rank, world, job):
    """Train steps of the model of each ``job["runs"]`` entry (a config,
    a step count, a dtype; the same first state on every rank) on this
    rank's rows of the global batch (test_torch_port_ddp_train.py): the
    record of the first step and the state after the last, per run."""
    from lidarseg3d_torch.apis import train as tr
    from lidarseg3d_torch.models import build_detector
    from lidarseg3d_torch.solver.optim import build_one_cycle_optimizer

    out = {}
    for name, (cfg, steps, dtype) in job["runs"].items():
        batch = to_dtype(tr.example_to_device(job["batches"][rank], "cpu"),
                         dtype)
        model = build_detector(cfg, device="cpu")
        model.load_state_dict(job["state"])
        model.to(dtype)
        opt, _ = build_one_cycle_optimizer(*job["optimizer"],
                                           grad_clip=job["clip"])
        state = tr.create_train_state(model, opt)
        step = tr.make_train_step(model, opt, job["grid"])
        for i in range(steps):
            state, ldict = step(state, batch)
            if i == 0:
                out[name] = record_step(model, ldict)
        out[name]["last"] = {k: v.clone()
                             for k, v in model.state_dict().items()}
    return out


def train_tool_rank(rank, world, argv):
    """``lidarseg3d_torch.tools.train`` on this rank, started by its
    ``--dist_*`` flags (test_torch_port_ddp_entry.py): the final state."""
    from lidarseg3d_torch.parallel import dist
    from lidarseg3d_torch.tools import train

    out = train.main(argv + ["--dist_num_processes", str(world),
                             "--dist_process_id", str(rank)])
    assert not dist.active()  # the group the tool started ended with it
    return {k: v.clone() for k, v in out["state"].model.state_dict().items()}


def eval_tool_rank(rank, world, argv, url, test_dir):
    """``lidarseg3d_torch.tools.test`` on this rank in a process group
    whose rank and size come from torchrun's ``RANK`` / ``WORLD_SIZE`` /
    ``LOCAL_RANK`` and whose rendezvous is ``url``
    (test_torch_port_ddp_entry.py; a ``file://`` URL, so no port is
    chosen before it is bound): its detections and result; the device
    histogram of ``run_eval_device_hist`` over this rank's shard; then the
    tool on the test split, writing its files to ``test_dir``."""
    from lidarseg3d_torch.apis.eval import run_eval_device_hist
    from lidarseg3d_torch.datasets import SegDataLoader, build_dataset
    from lidarseg3d_torch.parallel import dist
    from lidarseg3d_torch.tools import test
    from lidarseg3d_torch.utils.config import Config

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    assert dist.init_distributed(url, device="cpu") == (rank, world)
    out = test.main(argv)
    cfg = Config.fromfile(argv[0])
    ds = build_dataset(cfg.data.val.to_dict())
    with SegDataLoader(ds, 1, shuffle=False, drop_last=False, num_hosts=world,
                       host_id=rank, num_workers=1, **cfg.capacity) as loader:
        _, _, hist = run_eval_device_hist(
            out["state"].model, out["state"], loader, test.input_shape_of(cfg),
            ds, cfg.num_class)
    test.main(argv + ["--testset", "--work_dir", test_dir])
    return {"detections": out["detections"], "results": out["results"],
            "hist": hist}
