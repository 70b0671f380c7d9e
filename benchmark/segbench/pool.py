"""The pool of host batches a run cycles over, built in set-up by the
configuration's own pipeline from the seeded frames of ``scans``.

The pipeline's file loads are replaced by ``scans.loaded_frame``; every
later stage of the configuration's pipeline (train or val) runs as the
port's datasets run it, then the port's collate pads the frames to the
configuration's capacities. A traffic mix with ``tta`` puts the port's
SegCompoundAug in front of SegVoxelization, as ``tools.test --tta`` does,
so each frame becomes that many consecutive batch rows.
"""

import numpy as np

from . import scans

FILE_LOADS = ("LoadPointCloudFromFile", "LoadImageFromFile",
              "LoadPointCloudAnnotations")
SCENE_SEED = 0x5EED5CA7  # the wall layouts every seed's pool shares


def pipeline_stages(cfg, mode, tta=None):
    """The configuration's train or val stages after its file loads."""
    pipe = cfg["train_pipeline" if mode == "train" else "val_pipeline"]
    stages = []
    for st in pipe:
        st = dict(st)
        if st["type"] in FILE_LOADS:
            continue
        if tta and st["type"] == "SegVoxelization":
            stages.append(dict(type="SegCompoundAug", cfg=dict(tta)))
            st["cfg"] = dict(st["cfg"], tta_flag=True, **tta)
        stages.append(st)
    return stages


def frame_info(cfg, token):
    """The ``info`` a SemanticKITTIDataset hands its pipeline."""
    info = {"token": token,
            "dim": {"points": 4, "sem_labels": 1, "inst_labels": 1}}
    if cfg.get("use_img"):
        attrs = cfg["cam_attributes"]
        info["cam"] = {
            "names": list(cfg["cam_names"]),
            "attributes": {k: {"mean": np.asarray(v["mean"], np.float32),
                               "std": np.asarray(v["std"], np.float32)}
                           for k, v in attrs.items()},
            "resized_shape": tuple(cfg["img_resized_shape"])}
    return info


def frame_sizes(traffic, count):
    """The point counts of the pool's frames: evenly over the traffic's
    (low, high) range, the same for every seed."""
    lo, hi = traffic["points"]
    return np.linspace(lo, hi, count).round().astype(int).tolist()


def build_pool(cfg, traffic, seed, batch_size):
    """``traffic["pool_batches"]`` collated host batches (numpy) of
    ``batch_size`` frames each. Every seed gets the same set of frame
    sizes and wall layouts (``SCENE_SEED``), in an order and with returns,
    images and augmentations drawn from ``seed``, so that the work of a
    pool does not change with the seed."""
    from lidarseg3d_torch.datasets.batching import collate_segnet
    from lidarseg3d_torch.datasets.pipelines.compose import Compose

    mode = traffic["mode"]
    compose = Compose(pipeline_stages(cfg, mode, traffic.get("tta")))
    cams = tuple(cfg["cam_names"]) if cfg.get("use_img") else ()
    cap = cfg["capacity"]
    rng = np.random.default_rng([seed, 0x5CA7])
    count = traffic["pool_batches"] * batch_size
    slots = rng.permutation(count)
    sizes = frame_sizes(traffic, count)
    pool = []
    for b in range(traffic["pool_batches"]):
        frames = []
        for j in range(batch_size):
            slot = int(slots[b * batch_size + j])
            token = f"scan_{slot}"
            sample = scans.loaded_frame(
                rng, sizes[slot], np.random.default_rng([SCENE_SEED, slot]),
                traffic["max_range"], cams, tuple(traffic["image_hw"]),
                labels=mode == "train")
            sample.update(type="SemanticKITTIDataset", rng=rng,
                          metadata={"token": token,
                                    "num_point_features": 4})
            fr, _ = compose(sample, frame_info(cfg, token))
            frames.extend(fr if isinstance(fr, list) else [fr])
        pool.append(collate_segnet(frames, cap["max_voxels"],
                                   cap["max_points"],
                                   cfg.get("ignore_label", 0),
                                   on_overflow="error"))
    return pool
