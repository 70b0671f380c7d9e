"""Plain-PyTorch reference of the benchmark's two segmentors, MSeg3D
(``SegMSeg3DNet``) and SDSeg3D (``SegNet``), for the comparison that
decides a run's ``correct`` and for the operation counts of its
utilization metrics.

The dense layers (readers, HRNet and its FCN head, the point heads, the
losses, the optimizer) are frozen copies of the port's plain PyTorch
modules with their imports made local. The sparse part is written here
from its definition and shares no code with the port: structures,
rulebooks by a binary search of sorted voxel keys (``sparse.py``), convs
that gather only the rows with a partner (``sparse.py``), and the point
devoxelization (``interpolate.py``). Nothing here imports
``lidarseg3d_torch``, ``lidarseg3d_tpu`` or JAX.
"""

from .builder import build
from .train import build_optimizer, to_device, train_step

__all__ = ["build", "build_optimizer", "to_device", "train_step"]
