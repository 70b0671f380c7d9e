"""Shared fixtures and helpers of the port's evaluation-slice tests (the
mini MSeg3D configuration, its val dataset over a tree, one torch thread
per module); no tests of its own."""

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
