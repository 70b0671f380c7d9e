"""Device selection and the port's numerical precision (one place).

Precision: fp32 everywhere except an image branch configured with
``compute_dtype="bfloat16"`` (models/img_backbones/hrnet.py, bf16
activations with fp32 parameters and BN). TF32 is switched off for both
matmuls and cuDNN convolutions, because cuDNN runs fp32 convolutions in
TF32 by default (about three decimal digits) and the JAX reference runs
them in full fp32 on the CPU. Every entry point resolves its device here,
so the flags are set before any kernel of the port runs.
"""

import torch


def set_precision():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None):
    """``None`` means ``cuda``. Raises when CUDA is asked for and absent:
    the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "lidarseg3d_torch runs on cuda by default, but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch versions of the kernels on the CPU")
    set_precision()
    return dev
