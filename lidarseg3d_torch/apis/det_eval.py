"""Detection evaluation loop (PyTorch port of lidarseg3d_tpu/apis/det_eval.py):
batched inference and decode (rotated or circle NMS, as ``test_cfg``
says) -> per-frame box dicts {token: {box3d_lidar, scores, label_preds,
valid[, velocity]}}, ready for core/det_metrics.py and the submission
writers (datasets/{nuscenes,waymo}/det_submission.py).

Under double-flip TTA (``test_cfg["double_flip"]``) each frame is 4
consecutive batch rows, merged into one prediction before the decode.
In a multi-process run each process keeps the frames it owns (the
loader's sampler), so each frame counts once.
"""

import pickle

from .train import example_to_device


def run_det_eval(model, state, loader, input_shape, logger=None,
                 test_cfg=None):
    """-> {token: det dict} over the frames of the loader's epoch 0 that
    this process owns, each array a numpy copy of the frame's
    [T * max_out] decode."""
    dev = next(state.model.parameters()).device
    stride = 4 if (test_cfg or {}).get("double_flip") else 1
    owned = loader.sampler.owned(0)
    m = state.model.eval()
    detections = {}
    for it, batch in enumerate(loader.epoch(0)):
        if len(batch["metadata"]) % stride:
            raise AssertionError(
                "double_flip batches must hold whole groups of 4 variants")
        ex = example_to_device(batch, dev)
        ex["input_shape"] = tuple(int(s) for s in input_shape)
        rets, bat = m(ex)
        out = m.predict(rets, bat, test_cfg)
        keys = ["box3d_lidar", "scores", "label_preds", "valid"]
        if "velocity" in out:
            keys.append("velocity")
        host = {k: out[k].cpu().numpy() for k in keys}
        for b, md in enumerate(batch["metadata"][::stride]):
            if not owned[it, b]:
                continue
            token = (md or {}).get("token", f"frame_{it}_{b}")
            detections[token] = {k: host[k][b] for k in keys}
        if logger is not None and (it + 1) % 20 == 0:
            logger.info(f"det eval: {len(detections)} frames")
    return detections


def save_detections(detections, path):
    with open(path, "wb") as f:
        pickle.dump(detections, f)
    return path


def frame_ground_truth(dataset, tokens):
    """{token: (gt_boxes [N, 7], gt_names)} of the frames in ``tokens``:
    from the info (nuScenes) or the frame pkl's annotations (Waymo), as
    the JAX tool reads them; frames without boxes are left out."""
    gts = {}
    for info in getattr(dataset, "_infos", []):
        token = info.get("token")
        if token not in tokens:
            continue
        if "gt_boxes" in info:
            gts[token] = (info["gt_boxes"][:, :7], info["gt_names"])
        elif "path" in info:
            with open(dataset._path(info) if hasattr(dataset, "_path")
                      else info["path"], "rb") as f:
                anns = pickle.load(f).get("annotations", {})
            if "gt_boxes" in anns:
                gts[token] = (anns["gt_boxes"][:, :7], anns["gt_names"])
    return gts
