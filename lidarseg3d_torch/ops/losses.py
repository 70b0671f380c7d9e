"""Segmentation losses under static-shape padding (PyTorch port of
lidarseg3d_tpu/ops/losses.py).

Lovász-softmax: per class, the sorted errors dotted with the Lovász
gradient, averaged over the classes present in the valid labels. Padding
and ignored entries carry zero error and zero foreground and are sorted to
the back, so they contribute to no prefix that holds a valid element.

In a multi-process run both losses are those of the global batch, as in
the JAX package's SPMD step: the cross-entropy's sums are summed over the
ranks before the division, and Lovász sorts the rows of every rank
(parallel/dist.py). Every rank then holds the same loss value.
"""

import torch

from ..parallel import dist


def cross_entropy(logits, labels, ignore_index=0, valid=None):
    """Mean CE over the valid entries (nn.CrossEntropyLoss(ignore_index)).
    logits [N, C]; labels [N] int; valid: optional [N] bool extra mask."""
    ok = labels != ignore_index
    if valid is not None:
        ok = ok & valid
    safe = labels.clamp(0, logits.shape[-1] - 1).to(torch.int64)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, safe[:, None])[:, 0]
    okf = ok.to(logits.dtype)
    return dist.global_ratio((nll * okf).sum(), okf.sum())


def lovasz_softmax(probas, labels, ignore=None, valid=None,
                   classes="present"):
    """Multi-class Lovász-softmax over flat predictions. probas [N, C]
    softmax probabilities; labels [N] int; ``ignore``: label value left
    out of the loss and of the foreground counts; ``valid``: optional [N]
    bool mask of padding rows; ``classes="present"`` averages over the
    classes with foreground.

    All classes are sorted at once, [C, N]. The sort is stable and
    descending, so ties fall as the JAX package's ``argsort(-key)`` puts
    them: the loss does not depend on the order of ties, the per-element
    gradient does."""
    ok = torch.ones(probas.shape[0], dtype=torch.bool, device=probas.device)
    if ignore is not None:
        ok = ok & (labels != ignore)
    if valid is not None:
        ok = ok & valid
    if dist.active():  # the rows of every rank, in the global batch's order
        probas = dist.gather_rows(probas)
        labels = dist.gather_rows(labels.to(torch.int64))
        ok = dist.gather_rows(ok.to(torch.uint8)).bool()
    N, C = probas.shape
    okf = ok.to(probas.dtype)
    cls = torch.arange(C, device=probas.device)
    fg = ((labels[None, :] == cls[:, None]) & ok[None, :]).to(probas.dtype)
    errors = (fg - probas.T).abs() * okf[None, :]  # [C, N]
    key = torch.where(ok[None, :], errors.detach(), -torch.inf)
    order = torch.sort(-key, dim=1, stable=True).indices
    errors_s = errors.gather(1, order)
    fg_s = fg.gather(1, order)
    gts = fg_s.sum(dim=1, keepdim=True)
    intersection = gts - fg_s.cumsum(dim=1)
    union = (gts + (1.0 - fg_s).cumsum(dim=1)
             - (1.0 - okf)[order].cumsum(dim=1))
    jaccard = 1.0 - intersection / union.clamp(min=1e-12)
    grad = torch.cat([jaccard[:, :1], jaccard[:, 1:] - jaccard[:, :-1]],
                     dim=1)
    losses = (errors_s * grad).sum(dim=1)
    if classes == "present":
        pf = (gts[:, 0] > 0).to(probas.dtype)
        return (losses * pf).sum() / pf.sum().clamp(min=1.0)
    return losses.mean()
