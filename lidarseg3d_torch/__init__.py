"""lidarseg3d_torch: the PyTorch + CUDA port of lidarseg3d_tpu.

The package mirrors the module tree of ``lidarseg3d_tpu`` (``ops/``,
``models/...``, ``utils/``, ``core/``, ``datasets/``) so every module's
counterpart sits under the same path. It imports torch and numpy only;
nothing of JAX, Flax or the JAX package.

Entry points (``models.build_detector``, the model's forward, ``predict``)
run on ``cuda`` unless the caller passes ``device="cpu"``; precision is set
in one place, ``utils.device.resolve_device``.
"""
