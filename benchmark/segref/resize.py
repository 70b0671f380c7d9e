"""Bilinear resize, half-pixel convention (PyTorch port of
lidarseg3d_tpu/ops/resize.py:108 resize_bilinear).

For upscaling, ``jax.image.resize(..., "bilinear")`` and
``F.interpolate(mode="bilinear", align_corners=False)`` sample the same
half-pixel positions with the same edge clamping, so they agree; upsampling
is the only use on the MSeg3D path (HRNet fusion and the FCN head's
resize-concat). On a downscale ``jax.image.resize`` antialiases and
F.interpolate does not, so a downscale raises here.
"""

import torch.nn.functional as F


def resize_bilinear(x, out_hw):
    """NCHW x -> NCHW at spatial ``out_hw`` (upscale or identity only)."""
    H, W = int(x.shape[-2]), int(x.shape[-1])
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if (oh, ow) == (H, W):
        return x
    if oh < H or ow < W:
        raise NotImplementedError(
            f"bilinear downscale {H}x{W} -> {oh}x{ow}: the reference "
            "antialiases on downscale; no path of the port needs it")
    return F.interpolate(x, size=(oh, ow), mode="bilinear",
                         align_corners=False)
