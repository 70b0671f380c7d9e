"""Shared inputs of the detection tests (tests/test_torch_port_det*.py;
this module holds no test): seeded collated batches with CenterPoint
targets, the model configs of the mini VoxelNet and PointPillars, and the
train step each gloo rank of test_torch_port_det_train.py runs. No JAX
here: the spawned ranks import it."""

import copy
import os

import numpy as np

from lidarseg3d_torch.core.center_targets import assign_center_targets
from lidarseg3d_torch.core.voxelize import VoxelGenerator
from lidarseg3d_torch.datasets.batching import collate_segnet
from lidarseg3d_torch.utils.config import Config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MINI_VOXELNET = os.path.join(ROOT, "configs/tests/mini_waymo_voxelnet.py")
PP_PCR = [-12.8, -12.8, -2.0, 12.8, 12.8, 4.0]
PP_VSZ = [0.4, 0.4, 6.0]


def voxelnet_cfg(vel=False):
    """The mini Waymo VoxelNet (configs/tests/mini_waymo_voxelnet.py); with
    ``vel`` a velocity head and 10 code weights, as the nuScenes and
    two-sweep configs have. -> (model dict with train_cfg / test_cfg,
    point cloud range, voxel size, tasks)."""
    cfg = Config.fromfile(MINI_VOXELNET)
    m = copy.deepcopy(cfg.model.to_dict())
    m["train_cfg"] = copy.deepcopy(cfg.train_cfg.to_dict())
    m["test_cfg"] = copy.deepcopy(cfg.test_cfg.to_dict())
    if vel:
        m["bbox_head"]["common_heads"]["vel"] = (2, 2)
        m["bbox_head"]["code_weights"] = (1.0,) * 6 + (0.2, 0.2, 1.0, 1.0)
    return m, list(cfg.point_cloud_range), list(cfg.voxel_size), \
        [list(range(3))]


def pointpillars_cfg():
    """The published Waymo PointPillars model cut to 16-wide PFN layers
    and RPN blocks on a 64x64 canvas (out_size_factor 1)."""
    tasks = (dict(num_class=3, class_names=["VEHICLE", "PEDESTRIAN",
                                            "CYCLIST"]),)
    m = dict(
        type="PointPillars",
        reader=dict(type="PillarFeatureNet", num_filters=(16, 16),
                    num_input_features=5, with_distance=False,
                    voxel_size=tuple(PP_VSZ), pc_range=tuple(PP_PCR)),
        backbone=dict(type="PointPillarsScatter", num_input_features=16),
        neck=dict(type="RPN", layer_nums=(1, 1, 1), ds_layer_strides=(1, 2, 2),
                  ds_num_filters=(16, 32, 32), us_layer_strides=(1, 2, 4),
                  us_num_filters=(16, 16, 16), num_input_features=16),
        bbox_head=dict(type="CenterHead", in_channels=48, tasks=tasks,
                       dataset="waymo", weight=2, code_weights=(1.0,) * 8,
                       common_heads={"reg": (2, 2), "height": (1, 2),
                                     "dim": (3, 2), "rot": (2, 2)},
                       share_conv_channel=16),
        test_cfg=dict(nms_iou_threshold=0.7, score_threshold=0.1,
                      pc_range=PP_PCR[:2], out_size_factor=1,
                      voxel_size=PP_VSZ[:2], max_out=40))
    return m, PP_PCR, PP_VSZ, [list(range(3))]


def grid(pcr, vsz):
    g = np.round((np.asarray(pcr[3:], np.float32)
                  - np.asarray(pcr[:3], np.float32))
                 / np.asarray(vsz, np.float32)).astype(int)
    return (int(g[2]) + 1, int(g[1]), int(g[0]))


def det_batch(B, pcr, vsz, task_ids, seed=0, npts=1500, nboxes=6,
              max_voxels=2048, max_points=2048, points_per_voxel=5,
              out_factor=8, vel=False, frames=False, gt=False):
    """A collated batch of B frames: uniform points plus returns inside
    ``nboxes`` boxes of the tasks' classes, voxelized on (pcr, vsz), with
    the boxes' CenterPoint targets (velocity with ``vel``; with ``gt`` also
    the two-stage head's ``gt_boxes_and_cls`` [16, 8], 1-based classes);
    with ``frames`` the list of frames instead."""
    rng = np.random.default_rng(seed)
    vg = VoxelGenerator(vsz, pcr, max_num_points=points_per_voxel,
                        max_voxels=max_voxels)
    ncls = sum(len(t) for t in task_ids)
    lo, hi = np.asarray(pcr[:3]), np.asarray(pcr[3:])
    frames_out, out = frames, []
    for _ in range(B):
        dims = rng.uniform(0.6, 4.0, (nboxes, 3))
        ctr = rng.uniform(lo * 0.8, hi * 0.8, (nboxes, 3))
        ctr[:, 2] = lo[2] + dims[:, 2] / 2 + 0.2
        yaw = rng.uniform(-np.pi, np.pi, (nboxes, 1))
        cols = [ctr, dims, yaw]
        if vel:
            cols.append(rng.uniform(-3, 3, (nboxes, 2)))
        boxes = np.concatenate(cols, 1).astype(np.float32)
        inside = []
        for b in boxes:
            k = 30
            loc = rng.uniform(-0.45, 0.45, (k, 3)) * b[3:6]
            c, s = np.cos(b[6]), np.sin(b[6])
            inside.append(np.stack([loc[:, 0] * c - loc[:, 1] * s + b[0],
                                    loc[:, 0] * s + loc[:, 1] * c + b[1],
                                    loc[:, 2] + b[2]], 1))
        xyz = np.concatenate([rng.uniform(lo, hi, (npts, 3))] + inside)
        pts = np.concatenate([xyz, rng.uniform(0, 1, (len(xyz), 2))],
                             1).astype(np.float32)
        voxels, coords, nper = vg.generate(pts)
        g = grid(pcr, vsz)
        cls = rng.integers(0, ncls, nboxes)
        tg = assign_center_targets(
            boxes, cls, task_ids,
            (g[1] // out_factor, g[2] // out_factor), list(vsz[:2]) + [1.0],
            pcr, out_factor=out_factor, max_objs=16, min_overlap=0.1)
        out.append(dict(voxels=voxels, coordinates=coords,
                        num_points_per_voxel=nper, points=pts,
                        det_targets=tg))
        if gt:
            gtc = np.zeros((16, 8), np.float32)
            gtc[:nboxes, :7] = boxes[:, :7]
            gtc[:nboxes, 7] = cls + 1
            out[-1]["gt_boxes_and_cls"] = gtc
    if frames_out:
        return out
    return collate_segnet(out, max_voxels, max_points)


def device_batch(batch, dtype):
    """A collated detection batch on the CPU with its floats in
    ``dtype``."""
    import torch

    from lidarseg3d_torch.apis.train import example_to_device

    ex = example_to_device(batch, "cpu")

    def cast(d):
        return {k: v.to(dtype) if v.is_floating_point() else v
                for k, v in d.items() if k != "det_targets"}

    out = cast(ex)
    out["det_targets"] = [cast(t) for t in ex["det_targets"]]
    return out


def det_step_rank(rank, world, job):
    """One make_train_step of job["cfg"]'s model from job["state"] on this
    rank's batch (job["batches"][rank]) in job["dtype"]: the loss terms,
    the gradients and the state after the step."""
    import torch

    from lidarseg3d_torch.apis import train as tr
    from lidarseg3d_torch.models import build_detector
    from lidarseg3d_torch.solver.optim import build_one_cycle_optimizer

    torch.manual_seed(0)
    model = build_detector(copy.deepcopy(job["cfg"]), device="cpu")
    model.load_state_dict(job["state"])
    model.to(job["dtype"])
    opt, _ = build_one_cycle_optimizer(*job["optimizer"],
                                       grad_clip=job["clip"])
    state = tr.create_train_state(model, opt)
    step = tr.make_train_step(model, opt, job["grid"])
    _, ldict = step(state, device_batch(job["batches"][rank], job["dtype"]))
    return dict(losses={k: float(v) for k, v in ldict.items()},
                grads={k: p.grad.clone() for k, p in model.named_parameters()
                       if p.grad is not None},
                state={k: v.clone() for k, v in model.state_dict().items()})
