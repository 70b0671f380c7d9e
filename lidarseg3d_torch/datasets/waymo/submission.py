"""Waymo 3D semantic segmentation submission writer (own copy of
lidarseg3d_tpu/datasets/waymo/submission.py).

Per frame, the TOP lidar's first- and second-return predictions are
scattered back into [64, 2650, 2] label range images (channel 1 = class)
and shipped zlib-compressed as serialized MatrixInt32 protos inside a
SegmentationFrameList. The converter stores each frame's TOP range-image
cells (``top_ri_indexing``) and flat point slices (``top_slices``) in the
pkl, so no tfrecord is read again. Only the proto packing needs
waymo_open_dataset, imported where it is used: ``_label_range_image`` and
``top_return_labels`` need numpy alone.
"""

import os
import os.path as osp
import pickle
import zlib

import numpy as np

TOP_LIDAR_ROW_NUM = 64
TOP_LIDAR_COL_NUM = 2650


def compress_int32_matrix(array):
    """zlib(serialized MatrixInt32) of ``array``."""
    from waymo_open_dataset import dataset_pb2

    m = dataset_pb2.MatrixInt32()
    m.shape.dims.extend(list(array.shape))
    m.data.extend(array.reshape(-1).tolist())
    return zlib.compress(m.SerializeToString())


def _label_range_image(indexing, labels):
    """Scatter per-point labels into the [64, 2650, 2] label range image:
    ``indexing`` holds each point's (col, row) cell."""
    ri = np.zeros((TOP_LIDAR_ROW_NUM, TOP_LIDAR_COL_NUM, 2), np.int32)
    n = min(len(indexing), len(labels))
    ri[indexing[:n, 1], indexing[:n, 0], 1] = labels[:n]
    return ri


def top_return_labels(labels, top_slices):
    """The TOP lidar's labels of the first and of the second return, cut
    from a frame's flat per-point ``labels`` by its ``top_slices``
    ({"ri1": [start, count], "ri2": [start, count]})."""
    return tuple(labels[top_slices[r][0]: top_slices[r][0]
                        + top_slices[r][1]] for r in ("ri1", "ri2"))


def write_segmentation_submission(dataset, detections, output_dir,
                                  account_name="",
                                  method_name="lidarseg3d_torch"):
    """Write ``OUTPUT_DIR/waymo_seg_submission.bin`` of the predictions;
    -> {"submission": path}."""
    from waymo_open_dataset import dataset_pb2
    from waymo_open_dataset.protos import segmentation_metrics_pb2
    from waymo_open_dataset.protos import segmentation_submission_pb2

    infos = {info["token"]: info for info in dataset._infos}
    frames = segmentation_metrics_pb2.SegmentationFrameList()
    for token, pred in detections.items():
        context_name, ts = token.rsplit("_", 1)
        labels = np.asarray(pred["pred_point_sem_labels"]).astype(np.int32)
        with open(dataset._path(infos[token]), "rb") as f:
            lid = pickle.load(f)["lidars"]
        if lid.get("top_slices") is None:
            raise ValueError(
                f"frame pkl for {token} lacks top_slices/top_ri_indexing; "
                "re-run create_semanticwaymo_infos with the current "
                "converter")
        ri1_lab, ri2_lab = top_return_labels(labels, lid["top_slices"])
        idx = lid["top_ri_indexing"]
        fr = frames.frames.add()
        fr.context_name = context_name
        fr.frame_timestamp_micros = int(ts)
        laser = dataset_pb2.Laser()
        laser.name = dataset_pb2.LaserName.TOP
        laser.ri_return1.segmentation_label_compressed = (
            compress_int32_matrix(_label_range_image(idx["ri1"], ri1_lab)))
        laser.ri_return2.segmentation_label_compressed = (
            compress_int32_matrix(_label_range_image(idx["ri2"], ri2_lab)))
        fr.segmentation_labels.append(laser)

    sub = segmentation_submission_pb2.SemanticSegmentationSubmission()
    sub.account_name = account_name
    sub.unique_method_name = method_name[:25]
    sub.inference_results.CopyFrom(frames)
    out = osp.join(output_dir or ".", "waymo_seg_submission.bin")
    os.makedirs(osp.dirname(osp.abspath(out)), exist_ok=True)
    with open(out, "wb") as f:
        f.write(sub.SerializeToString())
    return {"submission": out}
