"""Named profiler ranges around the port's layers.

``with span("reader"): ...`` opens the range ``lidarseg3d::reader`` while
a torch profiler is collecting (``tools.train --profile_dir``, or any
``torch.profiler.profile`` around the work); otherwise it enters one
shared no-op context and makes no call into the profiler. A range is an
operator-scope record on the profiler's host timeline, the clock of the
device's kernels too: a kernel belongs to the innermost range open at its
launch, and a range opened inside an autograd backward is recorded on the
thread that runs it. It is not a user annotation, of which the profiler
would also draw a shadow on the device's timeline, where a reader of the
trace that cannot tell the two apart would count it as device work.
Nothing is kept here; the running profiler records the ranges.
"""

import contextlib

import torch.autograd.profiler as _profiler
from torch._C._profiler import _RecordFunctionFast as _range

PREFIX = "lidarseg3d::"
NAMES = (
    "to_device",  # the host batch to the device
    "step",  # one train or eval step
    "image_branch",  # the camera backbone and image head
    "reader",  # the voxel feature encoder
    "rulebooks",  # structures, lookup tables and rulebooks
    "backbone",  # the sparse UNet: its self time is norms and activations
    "sparse_conv",  # one sparse conv's forward, or its dX and dW
    "head",  # the point head's forward, the losses, the prediction
    "backward",  # the backward pass of the step's loss
    "optimizer",  # the gradients' clip and the update
)
_OFF = contextlib.nullcontext()


def span(name):
    """The context that ranges ``name`` (one of ``NAMES``)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _range(PREFIX + name)
