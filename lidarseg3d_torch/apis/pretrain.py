"""Pretrained-weight loading: the ImageNet HRNet of the MSeg3D configs
(PyTorch port of lidarseg3d_tpu/apis/pretrain.py).

A converted HRNet checkpoint is a flax msgpack file {"params": ...,
"batch_stats": ...} of the HRNet subtree, as the JAX package writes and
reads it (its tools/convert_hrnet_checkpoint.py, or this package's
``tools/convert_hrnet_checkpoint.py`` from an mmcv state_dict). The port
reads and writes that format with ``msgpack`` alone: an array is flax's
extension type 1, the msgpack of (shape, dtype name, C-order bytes). The
file's tree is grafted into the image backbone as the JAX package grafts
it: a strict=False merge at the Flax tree level (``_merge_partial``),
with names carried across by ``convert.py``'s rules.
"""

import os

import msgpack
import numpy as np

from ..convert import flax_to_state_dict, state_dict_to_flax

_NDARRAY = 1  # flax's msgpack extension type of an array


def _ext_hook(code, data):
    if code != _NDARRAY:
        raise ValueError(f"flax msgpack extension {code}: only arrays (1) "
                         "are read")
    shape, dtype, buf = msgpack.unpackb(data, raw=True)
    return np.frombuffer(buf, dtype=np.dtype(dtype.decode())).reshape(shape)


def read_msgpack(path):
    """A flax msgpack file of array leaves -> nested dicts of numpy arrays
    (what flax.serialization.msgpack_restore returns for one)."""
    with open(path, "rb") as f:
        return msgpack.unpackb(f.read(), ext_hook=_ext_hook, raw=False)


def _ext_default(x):
    if not isinstance(x, np.ndarray):
        raise TypeError(f"cannot serialize {type(x).__name__}")
    x = np.ascontiguousarray(x)
    return msgpack.ExtType(_NDARRAY, msgpack.packb(
        (x.shape, x.dtype.name, x.tobytes("C")), use_bin_type=True))


def write_msgpack(tree, path):
    """Nested dicts of numpy arrays -> a flax msgpack file that
    flax.serialization.msgpack_restore reads (flax splits an array above
    2**30 bytes into chunks; no HRNet array comes near that)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(msgpack.packb(tree, default=_ext_default, strict_types=True))


def _merge_partial(dst, src, path="", stats=None):
    """strict=False merge: copy src leaves into dst where the key exists
    AND shapes match; count loaded/skipped/missing like torch's
    load_state_dict(strict=False) report (the JAX package's, entry for
    entry)."""
    stats = stats if stats is not None else {"loaded": 0, "skipped": [],
                                             "unexpected": []}
    for k, v in src.items():
        p = f"{path}/{k}" if path else k
        if k not in dst:
            stats["unexpected"].append(p)
            continue
        if isinstance(v, dict):
            if isinstance(dst[k], dict):
                _merge_partial(dst[k], v, p, stats)
            else:
                stats["skipped"].append(p)
            continue
        cur = dst[k]
        if np.shape(cur) == np.shape(v):
            dst[k] = v
            stats["loaded"] += 1
        else:
            stats["skipped"].append(
                f"{p}: checkpoint {np.shape(v)} vs model {np.shape(cur)}")
    return stats


def load_hrnet_pretrained(model, msgpack_path, submodule="img_backbone_mod",
                          logger=None):
    """Merge converted HRNet weights into ``model.<submodule>`` in place
    (its parameters and BN running statistics, on its device).

    strict=False, as the JAX package: a key the model lacks or a leaf of
    another shape (a w48 file into a w18 model) is reported and skipped.
    A missing file, or a model without ``submodule``, is a warning and
    loads nothing. Returns the merge report {"loaded": number of leaves,
    "skipped": [...], "unexpected": [...]}, or None when nothing was read.
    """
    if not os.path.isfile(msgpack_path):
        if logger:
            logger.warning(f"pretrained HRNet not found: {msgpack_path}")
        return None
    blob = read_msgpack(msgpack_path)
    sub = getattr(model, submodule, None)
    if sub is None:
        if logger:
            logger.warning(f"no {submodule} in model params; skip pretrain")
        return None
    variables = state_dict_to_flax(sub)
    stats = _merge_partial(variables["params"], blob["params"])
    if variables["batch_stats"] and blob.get("batch_stats"):
        _merge_partial(variables["batch_stats"], blob["batch_stats"],
                       stats=stats)
    sub.load_state_dict(flax_to_state_dict(sub, variables), strict=True)
    if logger:
        logger.info(
            f"loaded pretrained HRNet from {msgpack_path}: "
            f"{stats['loaded']} tensors")
        for s in stats["skipped"][:10]:
            logger.warning(f"pretrain skipped (shape mismatch): {s}")
        if stats["unexpected"]:
            logger.warning(
                f"pretrain: {len(stats['unexpected'])} unexpected keys "
                f"(e.g. {stats['unexpected'][:3]})")
        logger.info(f"pretrain report: loaded {stats['loaded']}, skipped "
                    f"{len(stats['skipped'])}, unexpected "
                    f"{len(stats['unexpected'])}")
    return stats
