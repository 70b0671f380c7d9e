"""Flax variables of the JAX package -> the port's ``state_dict``.

The port names its submodules after the JAX package's Flax scopes
(models/layers.py), so a parameter's Flax path, read with ``.`` for ``/``,
is its ``state_dict`` key, except for:

- nn.scan stacks, whose leaves carry a leading layer axis and unstack into
  a ModuleList: ``.../blocks/SparseBasicBlock_0/...`` (SparseBasicBlockStack)
  -> ``blocks.{i}``, ``.../scan/HRModule_0/...`` (HRModuleStack) ->
  ``scan.{i}``, ``.../SFFMDecoderLayer_0/...`` (the SFFM decoder) ->
  ``SFFMDecoderLayer_0.{i}``;
- leaf layouts, chosen by the type of the torch module that owns the leaf:
  Linear kernel [in, out] (or a DenseGeneral's [in, H, dh] / [H, dh, out])
  -> weight [out, in]; Conv2d kernel HWIO -> OIHW; sparse conv kernel
  [K, Cin, Cout] as is; BN/LayerNorm scale -> weight; BN batch_stats
  mean/var -> running_mean/running_var.

The conversion is strict: every leaf is consumed and every parameter and
buffer of the model is assigned, or it raises and names what is left.
"""

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from .models.sparse_modules import _SparseConvBase

_SCANS = (("blocks", "SparseBasicBlock_0"), ("scan", "HRModule_0"),
          (None, "SFFMDecoderLayer_0"))


def _leaves(tree, path=()):
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    else:
        yield path, np.asarray(tree)


def _unstack(path, arr):
    """Yield (torch path, array) for one Flax leaf, unstacking scans."""
    for parent, child in _SCANS:
        for j in range(len(path) - 1):
            if path[j] != child or (parent is not None
                                    and (j == 0 or path[j - 1] != parent)):
                continue
            for i in range(arr.shape[0]):
                if parent is None:
                    new = path[:j + 1] + (str(i),) + path[j + 1:]
                else:
                    new = path[:j] + (str(i),) + path[j + 1:]
                yield new, arr[i]
            return
    yield path, arr


def _convert_leaf(module, collection, leaf, arr):
    """-> (torch attribute name, array in torch layout)."""
    if collection == "batch_stats":
        return {"mean": "running_mean", "var": "running_var"}[leaf], arr
    if leaf == "scale":
        return "weight", arr
    if leaf == "bias":
        return "bias", arr.reshape(-1)
    if leaf == "kernel":
        if isinstance(module, nn.Linear):
            return "weight", arr.reshape(module.in_features, -1).T
        if isinstance(module, nn.Conv2d):
            return "weight", arr.transpose(3, 2, 0, 1)
        if isinstance(module, _SparseConvBase):
            return "weight", arr
    raise KeyError(f"no conversion for {collection} leaf {leaf!r} of "
                   f"{type(module).__name__}")


def flax_to_state_dict(model, variables):
    """variables: {"params": ..., "batch_stats": ...} nested dicts of
    numpy arrays (a Flax variable tree) -> state_dict for ``model``."""
    target = model.state_dict()
    out, leftover = {}, []
    for collection in ("params", "batch_stats"):
        for path, arr in _leaves(variables.get(collection, {})):
            for tpath, a in _unstack(path, arr):
                prefix = ".".join(tpath[:-1])
                try:
                    module = model.get_submodule(prefix)
                    name, value = _convert_leaf(module, collection,
                                                tpath[-1], a)
                except (AttributeError, KeyError):
                    leftover.append("/".join((collection,) + tpath))
                    continue
                key = f"{prefix}.{name}"
                if key not in target or key in out:
                    leftover.append("/".join((collection,) + tpath))
                    continue
                if tuple(value.shape) != tuple(target[key].shape):
                    raise ValueError(
                        f"{key}: Flax leaf {'/'.join(path)} converts to "
                        f"{tuple(value.shape)}, model expects "
                        f"{tuple(target[key].shape)}")
                out[key] = torch.from_numpy(np.array(value, np.float32))
    missing = sorted(set(target) - set(out))
    if leftover or missing:
        raise ValueError(
            f"strict conversion failed: {len(leftover)} Flax leaves not "
            f"consumed {leftover[:10]}; {len(missing)} model entries not "
            f"assigned {missing[:10]}")
    return out


def load_flax_variables(model, variables):
    """Load converted Flax variables into ``model`` (strict)."""
    model.load_state_dict(flax_to_state_dict(model, variables), strict=True)
    return model
