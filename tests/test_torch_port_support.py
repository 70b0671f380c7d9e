"""Shared fixtures and helpers of the port's evaluation-slice tests (the
mini MSeg3D configurations of SemanticKITTI and nuScenes, the val dataset
over a tree, one torch thread per module); no tests of its own."""

import copy
import os

import pytest
import torch

from lidarseg3d_torch.utils.config import Config

# the tests' MSeg3D configuration: tiny HRNet, UNetSCN3D r=1, a 12 m grid
MINI_CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "configs", "tests", "mini_semkitti_mseg3d.py")


def mini_config():
    return Config.fromfile(MINI_CONFIG)


# the published nuScenes MSeg3D config cut to a small model on a small
# tree: two cameras resized to 96x64, a 25.6 m grid at 0.4 m, tiny HRNet
# (frozen_stages=3, with_cp) and head widths; its pipelines, dataset,
# optimizer and remat options are the published ones
NUSC_CONFIG = os.path.join(os.path.dirname(MINI_CONFIG), "..", "semanticnusc",
                           "MSeg3D",
                           "semnusc_avgvfe_unetscn3d_hrnetw18_lr1en2_e12.py")
NUSC_CHANS = ["CAM_FRONT", "CAM_BACK"]
_MINI_NUSC = """
cam_chan = {chans!r}
cam_names = ["1", "2"]
cam_attributes = {{c: dict(mean=nusc_mean, std=nusc_std) for c in cam_names}}
img_resized_shape = (96, 64)
point_cloud_range = [-12.8, -12.8, -3.0, 12.8, 12.8, 3.0]
voxel_size = [0.4, 0.4, 0.3]
voxel_generator.update(range=point_cloud_range, voxel_size=voxel_size,
                       max_voxel_num=[2000, 2000])
capacity = dict(max_voxels=2048, max_points=2048)
train_preprocessor["npoints"] = 2000
hrnet_w18["extra"] = dict(
    stage1=dict(num_modules=1, num_branches=1, block="BOTTLENECK",
                num_blocks=(1,), num_channels=(8,)),
    stage2=dict(num_modules=1, num_branches=2, block="BASIC",
                num_blocks=(1, 1), num_channels=(4, 8)),
    stage3=dict(num_modules=1, num_branches=3, block="BASIC",
                num_blocks=(1, 1, 1), num_channels=(4, 8, 16)),
    stage4=dict(num_modules=1, num_branches=4, block="BASIC",
                num_blocks=(1, 1, 1, 1), num_channels=(4, 8, 16, 32)))
hrnet_w18["pretrained"] = None
fcn_head.update(in_channels=(4, 8, 16, 32), num_convs=1, channels=12)
model["backbone"].update(point_cloud_range=point_cloud_range,
                         voxel_size=voxel_size)
model["backbone"]["model_cfg"]["SCALING_RATIO"] = 1
model["point_head"]["model_cfg"].update(
    VOXEL_IN_DIM=16, VOXEL_CLS_FC=[16], VOXEL_ALIGN_DIM=16, IMAGE_IN_DIM=12,
    IMAGE_ALIGN_DIM=16, GEO_FUSED_DIM=16, OUT_CLS_FC=[16], MIMIC_FC=[16],
    SFPhase_CFG=dict(embeddings_proj_kernel_size=1, d_model=16, n_head=4,
                     n_layer=2, n_ffn=32, drop_ratio=0, activation="relu",
                     pre_norm=False))
for _split in ("train", "val", "test"):
    data[_split].update(
        root_path={root!r}, cam_chan=cam_chan, cam_names=cam_names,
        cam_attributes=cam_attributes, img_resized_shape=img_resized_shape,
        info_path={root!r} + "/" + data[_split]["info_path"].rsplit("/")[-1])
data.update(samples_per_gpu=2, workers_per_gpu=1)
log_config = dict(interval=1)
work_dir = {work!r}
"""


def write_mini_nusc_config(path, root, work_dir="unused"):
    """The mini nuScenes MSeg3D config over the tree at ``root`` (two
    cameras, NUSC_CHANS), written to ``path``; returns ``path``."""
    with open(NUSC_CONFIG) as f:
        text = f.read()
    with open(path, "w") as f:
        f.write(text + _MINI_NUSC.format(chans=NUSC_CHANS, root=root,
                                         work=work_dir))
    return path


def mini_val_dataset_cfg(root):
    """The mini config's val dataset (pipeline included) over ``root``."""
    ds = copy.deepcopy(mini_config().data.val.to_dict())
    ds["root_path"] = root
    return ds


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run a test module's torch ops on one thread (restored after it):
    the mini model's ops are small, and under several test workers torch's
    intra-op threads only contend (the eval and remat files took 1.7x as
    long with 8 threads as with one, alone on 8 cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
