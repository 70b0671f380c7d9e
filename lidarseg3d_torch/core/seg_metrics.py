"""Segmentation metrics: confusion histogram and per-class IoU (own copy of
lidarseg3d_tpu/core/seg_metrics.py, free of JAX).

The numpy functions are the JAX package's. ``confusion_hist`` is the
counterpart of its ``confusion_hist_jax``: the histogram of a batch on the
tensors' device, one ``torch.bincount``, so evaluation moves a [C, C]
array to the host instead of per-point predictions.
"""

import numpy as np
import torch


def fast_hist(pred, label, n):
    k = (label >= 0) & (label < n)
    bin_count = np.bincount(n * label[k].astype(int) + pred[k],
                            minlength=n ** 2)
    return bin_count[: n ** 2].reshape(n, n)


def per_class_iou(hist):
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.diag(hist) / (hist.sum(1) + hist.sum(0) - np.diag(hist))


def fast_hist_crop(output, target, unique_label):
    hist = fast_hist(output.flatten(), target.flatten(),
                     np.max(unique_label) + 2)
    hist = hist[unique_label + 1, :]
    hist = hist[:, unique_label + 1]
    return hist


def confusion_hist(pred, label, num_classes, valid=None):
    """pred, label: integer tensors of one shape; valid: optional bool
    mask. -> [num_classes, num_classes] int64 with hist[l, p] the count of
    points labelled l and predicted p; entries with a label or prediction
    out of [0, num_classes) are not counted."""
    pred = pred.reshape(-1).long()
    label = label.reshape(-1).long()
    ok = ((label >= 0) & (label < num_classes)
          & (pred >= 0) & (pred < num_classes))
    if valid is not None:
        ok = ok & valid.reshape(-1)
    idx = torch.where(ok, label * num_classes + pred,
                      num_classes * num_classes)
    hist = torch.bincount(idx, minlength=num_classes * num_classes + 1)
    return hist[:-1].reshape(num_classes, num_classes)


def miou_from_hist(hist, ignore_class=0):
    """Reference-style mIoU: per-class IoU over all classes except ignore."""
    hist = np.asarray(hist, dtype=np.float64)
    iou = per_class_iou(hist)
    keep = [c for c in range(hist.shape[0]) if c != ignore_class]
    vals = iou[keep]
    return float(np.nanmean(vals)), iou
