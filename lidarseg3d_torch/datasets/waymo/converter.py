"""Waymo tfrecord -> pkl conversion of 3D semantic segmentation frames
(own copy of lidarseg3d_tpu/datasets/waymo/converter.py).

Needs tensorflow and waymo_open_dataset at conversion time only (training
and evaluation read the pkl output); without them every entry point raises
ImportError (``_require_waymo``). Decoding uses the official frame_utils
helpers (range image -> point cloud, range image -> per-point labels);
the per-point camera projections come from the camera_projection range
images. The labels cover the TOP lidar's two returns.

Point order: for each return (ri1, then ri2), the lidars in
``frame.lasers`` order with TOP first. ``top_slices`` and
``top_ri_indexing`` let the submission writer rebuild the official label
range images without the tfrecords (``top_slices_of``).

Unlike the JAX package's converter, each info also carries the frame's
``cam_paths``: the image loader reads them from the info (the JAX
converter stores them in the frame pkl only, where its loader does not
look; ROADMAP §C). Each frame's ``laser_labels`` become the detection
boxes of its annotations (``gt_boxes``, ``gt_names``, ``gt_num_points``),
as in the JAX converter (``validate.validate_semanticwaymo`` checks that
the written frames carry them).
"""

import os
import os.path as osp
import pickle


def _require_waymo():
    try:
        import tensorflow as tf  # noqa: F401
        from waymo_open_dataset import dataset_pb2  # noqa: F401
        from waymo_open_dataset.utils import frame_utils  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "Waymo conversion requires `tensorflow` and `waymo_open_dataset` "
            "(pip install waymo-open-dataset-tf-2-11-0). These are only "
            "needed to convert tfrecords; training/eval use the pkl output."
        ) from e


def top_slices_of(ri_starts, top_counts):
    """{"ri1": [start, count], "ri2": [start, count]} of the TOP lidar's
    points in the flat order, from the offset of each return's first
    point and the TOP lidar's point count in each return."""
    return {r: [int(s), int(c)]
            for r, s, c in zip(("ri1", "ri2"), ri_starts, top_counts)}


def _top_range_image_indexing(range_images, ri_index):
    """(col, row) of the TOP lidar's valid range-image cells, in the order
    convert_range_image_to_point_cloud emits the points."""
    import numpy as np
    from waymo_open_dataset import dataset_pb2

    ri = range_images[dataset_pb2.LaserName.TOP][ri_index]
    arr = np.array(ri.data, np.float32).reshape(ri.shape.dims)
    rows, cols = np.where(arr[..., 0] > 0)
    return np.stack([cols, rows], axis=-1).astype(np.int32)


def decode_frame(frame):
    """One Frame proto -> the pkl frame dict (see dataset.py)."""
    import numpy as np
    from waymo_open_dataset.utils import frame_utils

    (range_images, camera_projections, seg_labels, range_image_top_pose
     ) = frame_utils.parse_range_image_and_camera_projection(frame)

    points_all, cp_all, labels_all = [], [], []
    num_seg_points = 0
    top_counts, ri_starts = [], []
    for ri_index in (0, 1):
        ri_starts.append(sum(len(p) for p in points_all))
        points, cps = frame_utils.convert_range_image_to_point_cloud(
            frame, range_images, camera_projections, range_image_top_pose,
            ri_index=ri_index, keep_polar_features=True)
        top_counts.append(len(points[0]))  # TOP first in lasers order
        if seg_labels:
            point_labels = \
                frame_utils.convert_range_image_to_point_cloud_labels(
                    frame, range_images, seg_labels, ri_index=ri_index)
        else:
            point_labels = [np.zeros((len(p), 2), np.int32) for p in points]
        for p, cp, pl in zip(points, cps, point_labels):
            # p: [N, 6] (range, intensity, elongation, x, y, z)
            points_all.append(np.concatenate(
                [p[:, 3:6], p[:, 1:3]], axis=1).astype(np.float32))
            # cp: [N, 6] (cam1 id, x, y, cam2 id, x, y): the first one
            cp3 = np.asarray(cp, np.float32)[:, :3].copy()
            cp3[cp3[:, 0] <= 0] = -100.0
            cp_all.append(cp3)
            pl = np.asarray(pl)  # [N, 2] (instance, semantic)
            if pl.size:
                labels_all.append(pl[:, 1].astype(np.uint8))
                num_seg_points += len(pl)
            else:
                labels_all.append(np.zeros(len(p), np.uint8))

    return frame_record(
        frame, np.concatenate(points_all, axis=0),
        np.concatenate(cp_all, axis=0), np.concatenate(labels_all, axis=0),
        num_seg_points, top_slices_of(ri_starts, top_counts),
        {"ri1": _top_range_image_indexing(range_images, 0),
         "ri2": _top_range_image_indexing(range_images, 1)})


def frame_record(frame, points, points_cp, labels, num_seg_points,
                 top_slices, top_ri_indexing):
    """The frame pkl's dict from the decoded arrays (points [N, 5] x, y,
    z, intensity, elongation) and the proto's pose, timestamp and
    ``laser_labels``, whose boxes (``_decode_laser_labels``) join the
    annotations, as in the JAX converter. Reads only attributes of
    ``frame``."""
    import numpy as np

    return {
        "veh_to_global": np.asarray(frame.pose.transform,
                                    np.float64).reshape(4, 4),
        "timestamp": frame.timestamp_micros / 1e6,
        "lidars": {
            "points_xyz": points[:, :3],
            "points_feature": points[:, 3:5],
            "points_cp": points_cp,
            "num_points_of_top_lidar": {
                "ri_return1": int(top_slices["ri1"][1]),
                "ri_return2": int(top_slices["ri2"][1])},
            "top_slices": top_slices,
            "top_ri_indexing": top_ri_indexing,
        },
        "annotations": {
            "point_sem_labels": labels,
            "num_seg_points": int(num_seg_points),
            **_decode_laser_labels(frame),
        },
    }


_WAYMO_TYPE_NAMES = {1: "VEHICLE", 2: "PEDESTRIAN", 3: "SIGN", 4: "CYCLIST"}


def _decode_laser_labels(frame):
    """frame.laser_labels -> the detection pipeline's gt boxes:
    ``gt_boxes`` [N, 7] (x, y, z, length, width, height, heading),
    ``gt_names`` (VEHICLE, PEDESTRIAN, SIGN, CYCLIST, else UNKNOWN) and
    ``gt_num_points`` (num_lidar_points_in_box)."""
    import numpy as np

    boxes, names, counts = [], [], []
    for lab in frame.laser_labels:
        b = lab.box
        boxes.append([b.center_x, b.center_y, b.center_z,
                      b.length, b.width, b.height, b.heading])
        names.append(_WAYMO_TYPE_NAMES.get(int(lab.type), "UNKNOWN"))
        counts.append(int(lab.num_lidar_points_in_box))
    return {
        "gt_boxes": np.asarray(boxes, np.float32).reshape(-1, 7),
        "gt_names": np.asarray(names, dtype=object),
        "gt_num_points": np.asarray(counts, np.int32),
    }


def export_frame_images(frame, token, image_dir):
    """Write each camera's JPEG (already encoded in the proto) to disk;
    -> cam_paths {cam_id (str): path}, cam_sizes {cam_id: (W, H)}."""
    os.makedirs(image_dir, exist_ok=True)
    cam_paths, cam_sizes = {}, {}
    for img in frame.images:
        cam_id = str(int(img.name))  # 1..5 (FRONT..SIDE_RIGHT)
        path = osp.join(image_dir, f"{token}_cam{cam_id}.jpg")
        with open(path, "wb") as f:
            f.write(img.image)
        cam_paths[cam_id] = path
    for calib in frame.context.camera_calibrations:
        cam_sizes[str(int(calib.name))] = (int(calib.width),
                                           int(calib.height))
    return cam_paths, cam_sizes


def create_semanticwaymo_infos(root, out_dir=None, nsweeps=1,
                               split="training", seg_only=True,
                               export_images=True):
    """Convert ``root/split/*.tfrecord`` into per-frame pkls and the info
    pkl ``out_dir/infos_{split}_{nsweeps:02d}sweeps_segdet.pkl``; with
    ``export_images`` each camera's JPEG is written beside the frames.
    -> the info pkl's path."""
    _require_waymo()
    import numpy as np
    import tensorflow as tf
    from waymo_open_dataset import dataset_pb2

    out_dir = out_dir or root
    frame_dir = osp.join(out_dir, f"{split}_frames")
    image_dir = osp.join(out_dir, f"{split}_images")
    os.makedirs(frame_dir, exist_ok=True)
    infos, prev_frames = [], []
    records = sorted(f for f in os.listdir(osp.join(root, split))
                     if "tfrecord" in f)
    for rec in records:
        ds = tf.data.TFRecordDataset(osp.join(root, split, rec),
                                     compression_type="")
        for data in ds:
            frame = dataset_pb2.Frame()
            frame.ParseFromString(bytearray(data.numpy()))
            has_seg = bool(
                frame.lasers[0].ri_return1.segmentation_label_compressed)
            if seg_only and split == "training" and not has_seg:
                continue  # only annotated frames carry seg labels
            obj = decode_frame(frame)
            token = f"{frame.context.name}_{frame.timestamp_micros}"
            cam_paths = {}
            if export_images:
                cam_paths, obj["cam_sizes"] = export_frame_images(
                    frame, token, image_dir)
            obj["cam_paths"] = cam_paths
            obj["token"] = token
            path = osp.join(frame_dir, f"{token}.pkl")
            with open(path, "wb") as f:
                pickle.dump(obj, f)
            ts = frame.timestamp_micros / 1e6
            pose = obj["veh_to_global"]
            # earlier frames of the same context as sweeps (newest
            # first), with the transform into this frame's vehicle frame
            sweeps = []
            ref_inv = np.linalg.inv(pose)
            # (the JAX converter's slice [-0:] lists every kept frame when
            # nsweeps == 1; none is read then)
            kept = prev_frames[len(prev_frames) - nsweeps + 1:] \
                if nsweeps > 1 else []
            for p in reversed(kept):
                if p["context"] != frame.context.name:
                    break
                sweeps.append({
                    "path": p["path"],
                    "sweep_to_ref": (ref_inv @ p["pose"]).astype("float32"),
                    "time_lag": float(ts - p["timestamp"])})
            infos.append({"token": token, "path": path,
                          "context": frame.context.name, "timestamp": ts,
                          "sweeps": sweeps, "cam_paths": cam_paths})
            prev_frames.append({"context": frame.context.name, "path": path,
                                "pose": pose, "timestamp": ts})
            if len(prev_frames) > 8:
                prev_frames.pop(0)
    info_path = osp.join(out_dir,
                         f"infos_{split}_{nsweeps:02d}sweeps_segdet.pkl")
    with open(info_path, "wb") as f:
        pickle.dump(infos, f)
    return info_path
