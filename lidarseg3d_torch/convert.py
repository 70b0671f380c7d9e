"""Flax variables of the JAX package -> the port's ``state_dict``.

The port names its submodules after the JAX package's Flax scopes
(models/layers.py), so a parameter's Flax path, read with ``.`` for ``/``,
is its ``state_dict`` key, except for:

- nn.scan stacks, whose leaves carry a leading layer axis and unstack into
  a ModuleList: ``.../blocks/SparseBasicBlock_0/...`` (SparseBasicBlockStack)
  -> ``blocks.{i}``, ``.../scan/HRModule_0/...`` (HRModuleStack) ->
  ``scan.{i}``, ``.../SFFMDecoderLayer_0/...`` (the SFFM decoder) ->
  ``SFFMDecoderLayer_0.{i}``, ``.../EncoderLayers/
  TransformerEncoderLayerPreNorm_0/...`` (TransVFE) -> ``EncoderLayers.{i}``;
- leaf layouts, chosen by the type of the torch module that owns the leaf:
  Linear kernel [in, out] (or a DenseGeneral's [in, H, dh] / [H, dh, out])
  -> weight [out, in]; Conv2d kernel HWIO -> OIHW; ConvTranspose kernel
  HWIO -> [in, out, H, W] flipped in both spatial axes (Flax's
  ``nn.ConvTranspose`` with ``transpose_kernel=False`` and SAME padding,
  kernel == stride, is torch's transposed conv of the flipped kernel);
  sparse conv kernel and DCN ``deform_kernel`` [K, Cin, Cout] as is;
  BN/LayerNorm scale -> weight; BN batch_stats mean/var ->
  running_mean/running_var.

The conversion is strict: every leaf is consumed and every parameter and
buffer of the model is assigned, or it raises and names what is left.

A gradient tree has the parameters' structure, so the same function carries
it across (``flax_params_to_named``): tests compare gradients and updated
parameters tensor by tensor under ``state_dict`` names.

``save_flax_checkpoint`` writes a JAX train state's ``params`` and
``batch_stats`` (as numpy trees) as a checkpoint of the port
(``apis.train.save_checkpoint``), which ``python -m
lidarseg3d_torch.tools.test`` then evaluates.
"""

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from .models.sparse_modules import _SparseConvBase

_SCANS = (("blocks", "SparseBasicBlock_0"), ("scan", "HRModule_0"),
          (None, "SFFMDecoderLayer_0"),
          ("EncoderLayers", "TransformerEncoderLayerPreNorm_0"))


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
    if leaf == "deform_kernel":  # DCN [K, C, Cout] as is
        return "deform_kernel", arr
    if leaf == "kernel":
        if isinstance(module, nn.Linear):
            return "weight", arr.reshape(module.in_features, -1).T
        if isinstance(module, nn.Conv2d):
            return "weight", arr.transpose(3, 2, 0, 1)
        if isinstance(module, nn.ConvTranspose2d):
            return "weight", arr[::-1, ::-1].transpose(2, 3, 0, 1)
        if isinstance(module, _SparseConvBase):
            return "weight", arr
    raise KeyError(f"no conversion for {collection} leaf {leaf!r} of "
                   f"{type(module).__name__}")


def flax_to_state_dict(model, variables,
                       collections=("params", "batch_stats")):
    """variables: {"params": ..., "batch_stats": ...} nested dicts of
    numpy arrays (a Flax variable tree) -> state_dict for ``model``. With
    ``collections=("params",)`` only the parameters are converted and
    required."""
    target = model.state_dict()
    if "batch_stats" in collections:
        required = set(target)
    else:
        required = {k for k, _ in model.named_parameters()}
    out, leftover = {}, []
    for collection in collections:
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
    missing = sorted(required - set(out))
    if leftover or missing:
        raise ValueError(
            f"strict conversion failed: {len(leftover)} Flax leaves not "
            f"consumed {leftover[:10]}; {len(missing)} model entries not "
            f"assigned {missing[:10]}")
    return out


def _flax_leaf(module, attr, arr):
    """The inverse of ``_convert_leaf``: a torch attribute of ``module``
    -> (collection, Flax leaf name, array in Flax layout)."""
    if attr in ("running_mean", "running_var"):
        return "batch_stats", attr[len("running_"):], arr
    if attr in ("bias", "deform_kernel"):
        return "params", attr, arr
    if attr == "weight":
        if isinstance(module, nn.Linear):
            return "params", "kernel", arr.T
        if isinstance(module, nn.Conv2d):
            return "params", "kernel", arr.transpose(2, 3, 1, 0)
        if isinstance(module, nn.ConvTranspose2d):
            return "params", "kernel", arr.transpose(2, 3, 0, 1)[::-1, ::-1]
        if isinstance(module, _SparseConvBase):
            return "params", "kernel", arr
        return "params", "scale", arr
    raise KeyError(f"no Flax leaf for {type(module).__name__}.{attr}")


def _restack(path):
    """The inverse of ``_unstack`` for one torch path -> (Flax path, index
    in the scan stack or None)."""
    for parent, child in _SCANS:
        for j in range(1, len(path) - 1):
            if not path[j].isdigit():
                continue
            if parent is not None and path[j - 1] == parent:
                return path[:j] + (child,) + path[j + 1:], int(path[j])
            if parent is None and path[j - 1] == child:
                return path[:j] + path[j + 1:], int(path[j])
    return path, None


def state_dict_to_flax(model):
    """The model's parameters and BN statistics as the Flax variable tree
    {"params": ..., "batch_stats": ...} of nested dicts of numpy arrays
    that ``flax_to_state_dict`` takes back (the same rules, inverted; a
    scan's ModuleList restacks on a leading axis; a model on the meta
    device gives arrays of the shapes only). Covers the leaves of
    Linear, Conv2d, sparse-conv and norm modules (DenseGeneral kernels of
    more than two axes are not recovered)."""
    trees = {"params": {}, "batch_stats": {}}
    stacks = {}
    for key, value in model.state_dict().items():
        prefix, _, attr = key.rpartition(".")
        arr = (np.empty(tuple(value.shape), np.float32) if value.is_meta
               else value.detach().cpu().numpy())
        coll, leaf, arr = _flax_leaf(model.get_submodule(prefix), attr, arr)
        path, i = _restack(tuple(prefix.split(".")) + (leaf,))
        if i is None:
            stacks[(coll,) + path] = arr
        else:
            stacks.setdefault((coll,) + path, {})[i] = arr
    for (coll, *path), arr in stacks.items():
        if isinstance(arr, dict):
            arr = np.stack([arr[i] for i in range(len(arr))])
        node = trees[coll]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(arr, dtype=np.float32)
    return trees


def flax_params_to_named(model, params):
    """A Flax tree with the structure of the model's ``params`` (the
    parameters of a train state, or a gradient tree) -> {name: tensor}
    under ``model.named_parameters()`` names, in torch layouts."""
    return flax_to_state_dict(model, {"params": params},
                              collections=("params",))


def load_flax_variables(model, variables):
    """Load converted Flax variables into ``model`` (strict)."""
    model.load_state_dict(flax_to_state_dict(model, variables), strict=True)
    return model


def save_flax_checkpoint(model, params, batch_stats, work_dir, epoch):
    """Load a JAX train state's ``params`` and ``batch_stats`` (nested
    dicts of numpy arrays) into ``model`` (strict) and save them as a
    weights-only checkpoint ``work_dir/epoch_{epoch}`` of the port.
    Returns the checkpoint's path."""
    from .apis.train import TrainState, save_checkpoint

    load_flax_variables(model, {"params": params,
                                "batch_stats": batch_stats})
    return save_checkpoint(work_dir, TrainState(
        step=0, model=model, opt_state=None, generator=None), epoch)
