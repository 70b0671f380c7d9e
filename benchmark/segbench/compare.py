"""The check that decides a run's ``correct``: what the timed path produced
against the reference (``segref``), given the same weights and host
batches; a cell compares the numbers its limits file names.

Training (the three steps set-up drove through the window's own step):
  ``loss_gap``   the largest relative gap of a step's total loss;
  ``grad_gap``   the largest gap between the norms of a leaf's first
                 gradient as the optimizer holds it (its first moment after
                 one step, divided by 1 - beta1), against the reference's
                 norm of that leaf or of the median leaf, the larger;
  ``grad_gap_p90`` that gap at the leaf at the 90th percentile of them:
                 steady where a few leaves' gradients cancel (MSeg3D's
                 sparse BN leaves on some seeds);
  ``change_gap`` the same for the norm of each leaf's change over the three
                 steps, leaving out the leaves whose reference gradient is
                 under a thousandth of the median leaf's (they move by
                 round-off alone).
  Medians are over the leaves with a non-zero reference gradient (the
  frozen stages have none).
Inference (the sampled pool batches' last outputs in the window):
  ``answer_gap`` the largest of two gaps over the valid points: of a
                 point's softmax against the reference's, and of the
                 reference's softmax (a TTA frame's: the mean of its rows)
                 at the label the program returned below the reference's
                 best. A label alone is no number to compare: the control
                 flips none on some seeds, so its reading does not separate
                 from the program's.

``lower_precision`` is the control: the reference computed with TF32 on
(on the CPU, matrix products and convolutions with inputs rounded to
TF32's 10-bit mantissa).
"""

from contextlib import contextmanager, nullcontext

import numpy as np

from . import cell


def _round_tf32(t):
    import torch

    if not (isinstance(t, torch.Tensor) and t.dtype == torch.float32):
        return t
    bits = t.detach().contiguous().view(torch.int32)
    r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    # the value rounded, the gradient passed on as it is
    return t + (r - t).detach() if t.requires_grad else r


@contextmanager
def lower_precision(device):
    import torch

    if device.type == "cuda":
        prev = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = prev
        return
    import torch.nn.functional as F
    from torch.overrides import TorchFunctionMode
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_map

    # the forward's products at the function level (inference tensors skip
    # the dispatch modes), the backward's at the operator level
    funcs = {torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__,
             torch.mm, torch.bmm, torch.addmm, torch.baddbmm, torch.einsum,
             F.linear, F.conv2d}
    aten = torch.ops.aten
    ops = {aten.mm.default, aten.addmm.default, aten.bmm.default,
           aten.baddbmm.default, aten.convolution.default,
           aten.convolution_backward.default}

    class TF32Functions(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func in funcs:
                args = tree_map(_round_tf32, args)
            return func(*args, **(kwargs or {}))

    class TF32Operators(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in ops:
                args = tree_map(_round_tf32, args)
            return func(*args, **(kwargs or {}))

    with TF32Functions(), TF32Operators():
        yield


def reference_outputs(cfg, traffic, pool, wts, seed, device, B,
                      batches=None, lower=False):
    """What the reference gives for the program's outputs: a train cell's
    {"losses", "grad", "change"}, an infer cell's {pool batch: (softmax
    [rows, N, C], [labels of each frame])} for ``batches``."""
    import torch

    import segref

    model = segref.build(cell.model_cfg(cfg)).to(device)
    model.load_state_dict(wts, strict=True)
    shape = cell.input_shape(cfg)
    ctx = lower_precision(device) if lower else nullcontext()
    with ctx:
        if traffic["mode"] == "train":
            tx = segref.build_optimizer(cfg,
                                        cell.schedule_steps(cfg, traffic, B))
            names = [n for n, _ in model.named_parameters()]
            opt = tx.init([p for _, p in model.named_parameters()])
            gen = torch.Generator(device=device).manual_seed(seed + 1)
            out = {"losses": []}
            for i in range(traffic["check_steps"]):
                ld = segref.train_step(
                    model, tx, opt, segref.to_device(pool[i % len(pool)],
                                                     device), shape, gen)
                out["losses"].append(float(ld["loss"]))
                if i == 0:
                    g = torch.stack(torch._foreach_norm(opt.mu))
                    out["grad"] = dict(zip(names, (
                        g.double().cpu() / (1.0 - tx.b1_fn(0))).tolist()))
            params = dict(model.named_parameters())
            out["change"] = {n: float(torch.linalg.vector_norm(
                params[n].detach() - wts[n])) for n in names}
            return out
        tta = int(traffic.get("tta", {}).get("num_tta_tranforms", 0))
        model.eval()
        out = {}
        for b in batches:
            batch = pool[b]
            ex = dict(segref.to_device(batch, device), input_shape=shape)
            ret, bat = model(ex)
            sm = model.predict(ret, bat)["point_softmax"].float().cpu().numpy()
            npts = batch["num_points_total"]
            if tta:
                labels = [np.argmax(sm[:, :int(npts[0])].mean(0), -1)]
            else:
                labels = [np.argmax(sm[r, :int(npts[r])], -1)
                          for r in range(len(npts))]
            out[b] = (sm, labels)
            del ex, ret, bat
        return out


def numbers(mode, program, ref, pool, tta=False):
    """The compared numbers -> {name: value}."""
    if mode == "train":
        lp, lr = np.asarray(program["losses"]), np.asarray(ref["losses"])
        loss_gap = float(np.max(np.abs(lp - lr) / np.abs(lr)))
        gr = ref["grad"]
        med_g = float(np.median([v for v in gr.values() if v > 0]))
        grads = [abs(program["grad"][n] - gr[n]) / max(gr[n], med_g)
                 for n in gr]
        moved = [n for n in gr if gr[n] >= 1e-3 * med_g]
        cr = ref["change"]
        med_c = float(np.median([cr[n] for n in moved]))
        change_gap = max(abs(program["change"][n] - cr[n])
                         / max(cr[n], med_c) for n in moved)
        return {"loss_gap": loss_gap, "grad_gap": float(max(grads)),
                "grad_gap_p90": float(np.quantile(grads, 0.9)),
                "change_gap": float(change_gap)}
    gap = 0.0
    for b, (sm_p, labels_p) in program.items():
        sm_r, _ = ref[b]
        npts = pool[b]["num_points_total"]
        for r in range(sm_p.shape[0]):
            n = int(npts[r])
            gap = max(gap, float(np.max(np.abs(sm_p[r, :n] - sm_r[r, :n]),
                                        initial=0.0)))
        frames = ([sm_r[:, :int(npts[0])].mean(0)] if tta else
                  [sm_r[r, :int(npts[r])] for r in range(sm_r.shape[0])])
        for best, got in zip(frames, labels_p):
            gap = max(gap, float(np.max(
                best.max(-1) - best[np.arange(len(got)), got], initial=0.0)))
    return {"answer_gap": gap}


def check(cfg, traffic, pool, program, wts, seed, device, B, limits):
    """The numbers the cell's limits name, each with its limit: {name:
    {"value", "limit"}}."""
    batches = None if traffic["mode"] == "train" else sorted(program)
    ref = reference_outputs(cfg, traffic, pool, wts, seed, device, B,
                            batches)
    tta = bool(traffic.get("tta"))
    vals = numbers(traffic["mode"], program, ref, pool, tta)
    return {k: {"value": vals[k], "limit": float(v)}
            for k, v in limits.items()}
