"""Evaluation loop: batched inference -> per-frame predictions -> dataset
mIoU (own copy of run_eval, run_eval_device_hist and evaluate_dataset of
lidarseg3d_tpu/apis/eval.py).

Each batch goes to the model's device, and only its int32 label rows come
back to the host; under test-time augmentation (TTA) its float32 softmax
rows come back instead. A frame's variants arrive as consecutive batch
rows (SegCompoundAug, Reformat, the loader); their softmax is summed in
variant order, divided by the count and the argmax taken (the reference's
merge_type "ArithmeticMean"). ``run_eval_device_hist`` keeps even the
confusion histogram on the device and moves a [C, C] array per batch.

In a multi-process run each process evaluates its shard of the frames
(the loader's sampler) and keeps the frames it owns: the repeated frames
that pad the shards to equal lengths are dropped, so each frame is counted
once when the datasets' evaluation sums the [C, C] histograms over the
processes (parallel/dist.py ``allreduce_hist``). The JAX package keeps
them, and counts a repeated frame once per process that holds it.
"""

import time

import numpy as np
import torch

from ..core.seg_metrics import confusion_hist, per_class_iou
from ..datasets.batching import pad_axis0
from ..parallel import dist
from .train import example_to_device, make_eval_step


def _device_of(state):
    return next(state.model.parameters()).device


def run_eval(model, state, loader, input_shape, dataset, logger=None,
             test_cfg=None, speed_test=False, latencies=None):
    """-> {token: {"pred_point_sem_labels": [n]}} over the frames of the
    loader's epoch 0 that this process owns (all of them in a single
    process; ``EpochSampler.owned``), n the frame's point count: int32
    labels, or under ``test_cfg["tta_flag"]`` the argmax (int64) of the
    mean softmax of the frame's ``test_cfg["num_tta_tranforms"]``
    variants (default 4); a
    frame with another number of rows raises, as the JAX package asserts.

    ``speed_test`` times each batch alone, from its dispatch to its labels
    being ready, between two ``torch.cuda.synchronize()`` calls with CUDA
    events (the host clock on the CPU), and logs the mean and p50 over the
    middle third of the batches, per batch row (a TTA variant counts as a
    row, as in the JAX package). ``latencies``, a list, receives every
    batch's seconds per row."""
    tta = bool(test_cfg and test_cfg.get("tta_flag", False))
    num_tta = int(test_cfg.get("num_tta_tranforms", 4)) if tta else 1
    key = "point_softmax" if tta else "pred_point_sem_labels"
    dev = _device_of(state)
    on_card = dev.type == "cuda"
    eval_step = make_eval_step(model, input_shape)
    lat = [] if latencies is None else latencies
    detections, pending = {}, {}  # pending: token -> (softmax sum, count)
    owned = loader.sampler.owned(0)
    for it, batch in enumerate(loader.epoch(0)):
        dev_batch = example_to_device(batch, dev)
        if speed_test:
            if on_card:
                torch.cuda.synchronize(dev)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            t0 = time.perf_counter()
        out = eval_step(state, dev_batch)[key]
        out = out.float() if tta else out.to(torch.int32)
        if speed_test:
            if on_card:
                end.record()
                torch.cuda.synchronize(dev)
                secs = start.elapsed_time(end) / 1e3
            else:
                secs = time.perf_counter() - t0
            lat.append(secs / len(batch["metadata"]))
        out = out.cpu().numpy()
        npts = batch["num_points_total"]
        for b, md in enumerate(batch["metadata"]):
            if not owned[it, b // num_tta]:  # a frame's variants run on
                continue
            token = md["token"] if md else f"frame_{it}_{b}"
            n = int(npts[b])
            if not tta:
                detections[token] = {"pred_point_sem_labels": out[b, :n]}
                continue
            acc, cnt = pending.get(token, (0.0, 0))
            acc, cnt = acc + out[b, :n], cnt + 1
            if cnt == num_tta:
                detections[token] = {
                    "pred_point_sem_labels": np.argmax(acc / cnt, axis=-1)}
                pending.pop(token, None)
            else:
                pending[token] = (acc, cnt)
    if pending:
        raise AssertionError(f"incomplete TTA groups: {list(pending)[:4]}")
    if speed_test and logger is not None:
        mid = np.asarray(lat[len(lat) // 3: 2 * len(lat) // 3])
        if len(mid):
            logger.info(f"speed_test: mean {mid.mean() * 1000:.1f} "
                        f"ms/frame, p50 {np.percentile(mid, 50) * 1000:.1f} "
                        "ms (unpipelined)")
    return detections


def run_eval_device_hist(model, state, loader, input_shape, dataset,
                         num_classes, logger=None):
    """Validation mIoU with the confusion histogram of every batch summed
    on the device, against each frame's label file as
    ``dataset.get_anno_for_eval`` reads it. Returns (miou, per-class IoU
    over classes 1..C-1, the [C, C] histogram); the ignore class 0 is
    dropped from both axes, as ``fast_hist_crop`` does. In a multi-process
    run each process counts the frames it owns and the histograms are
    summed over the processes."""
    dev = _device_of(state)
    eval_step = make_eval_step(model, input_shape)
    hist = torch.zeros(num_classes, num_classes, dtype=torch.int64,
                       device=dev)
    owned = loader.sampler.owned(0)
    for it, batch in enumerate(loader.epoch(0)):
        dev_batch = example_to_device(batch, dev)
        pred = eval_step(state, dev_batch)["pred_point_sem_labels"]
        n = batch["points"].shape[1]
        labels = np.stack([pad_axis0(dataset.get_anno_for_eval(md["token"])[
            "point_sem_labels"].astype(np.int64), n)
            for md in batch["metadata"]])
        mine = torch.from_numpy(owned[it]).to(dev)[:, None]
        hist += confusion_hist(pred, torch.from_numpy(labels).to(dev),
                               num_classes,
                               valid=dev_batch["point_valid"] & mine)
    hist = dist.allreduce_hist(hist.cpu().numpy())
    ious = per_class_iou(hist[1:, 1:])
    miou = float(np.nanmean(ious))
    if logger is not None:
        logger.info(f"device-hist val mIoU: {miou * 100:.2f}")
    return miou, ious, hist


def evaluate_dataset(dataset, detections, output_dir=None, testset=False,
                     logger=None):
    """The dataset's evaluation of ``detections`` -> its result (None on
    the test split, whose submission files it writes). In a multi-process
    run every process evaluates its own detections on the val split (the
    datasets sum the histograms over the processes) and rank 0 logs; on
    the test split rank 0 gathers every process's detections and writes
    the files."""
    if testset and dist.world_size() > 1:
        parts = dist.gather_to_main(detections)
        if not dist.is_main_process():
            return None
        detections = {k: v for part in parts for k, v in part.items()}
    res, _ = dataset.evaluation(detections, output_dir=output_dir,
                                testset=testset)
    if res is not None and logger is not None and dist.is_main_process():
        for k, v in res["results"].items():
            logger.info(f"{k}: {v:.2f}")
    return res
