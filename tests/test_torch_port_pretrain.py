"""The port's HRNet checkpoint import (lidarseg3d_torch.apis.pretrain and
lidarseg3d_torch.tools.convert_hrnet_checkpoint) against three references:

- the mmcv HRNetV2 manifests (tests/data/hrnetv2_w{18,48}_manifest.json,
  every key and shape of the real checkpoints): every entry maps onto the
  port's HRNet of that width, with equal shapes, w18's stride-2 fuse
  convs included, and lands in the tensor its name says;
- the JAX package's ``load_hrnet_pretrained`` + ``convert.py`` on a
  msgpack written by flax.serialization from seeded JAX HRNet variables:
  the same tensors loaded (bit for bit) and the same loaded / skipped /
  unexpected report, for a w18 file (with an unexpected subtree) and for
  a w48 file into a w18 model;
- an HRNet-w18 forward after both loads, within 1e-4 of the largest
  reference entry (fp32, another summation order)."""

import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from lidarseg3d_tpu.apis.pretrain import load_hrnet_pretrained as jload
from lidarseg3d_tpu.models import build_img_backbone as jbuild
from lidarseg3d_torch.apis import pretrain
from lidarseg3d_torch.convert import (flax_to_state_dict, load_flax_variables,
                                      state_dict_to_flax)
from lidarseg3d_torch.models import build_img_backbone as tbuild
from lidarseg3d_torch.tools import convert_hrnet_checkpoint as conv

from _torch_port_helpers import assert_close_rel, init_shapes, random_variables
from test_torch_port_support import one_torch_thread  # noqa: F401

DATA = os.path.join(os.path.dirname(__file__), "data")
IMG = (1, 64, 64, 3)
REL_FWD = 1e-4


def manifest(width):
    with open(os.path.join(DATA, f"hrnetv2_w{width}_manifest.json")) as f:
        return json.load(f)["entries"]


class Detector(torch.nn.Module):
    """A model holding the HRNet where the MSeg3D segmentor does."""

    def __init__(self, width):
        super().__init__()
        self.img_backbone_mod = tbuild(dict(
            type="HRNet", extra=conv.HRNET_EXTRA[width]))


def jax_variables(width, seed):
    m = jbuild(dict(type="HRNet", extra=conv.HRNET_EXTRA[width],
                    s2d_max_c=0))
    v = random_variables(init_shapes(m, jnp.zeros(IMG), train=False), seed)
    return m, jax.tree_util.tree_map(np.asarray, v)


def torch_name(path, m):
    """A Flax module path of the HRNet (scan index m) -> the port's name."""
    parts = list(path)
    if "scan" in parts:
        i = parts.index("scan")
        parts[i + 1] = str(m)
    return ".".join(parts)


@pytest.mark.parametrize("width", [18, 48])
def test_manifest_maps_every_entry(width, tmp_path):
    entries = manifest(width)
    rng = np.random.default_rng(width)
    sd = {k: (np.abs(rng.standard_normal(s)) if "running_var" in k
              else rng.standard_normal(s)).astype(np.float32)
          for k, s in entries}
    path = str(tmp_path / "w.msgpack")
    pretrain.write_msgpack(conv.convert(sd, conv.HRNET_EXTRA[width]), path)
    model = Detector(width)
    stats = pretrain.load_hrnet_pretrained(model, path)
    n_leaves = sum(1 for _ in jax.tree_util.tree_leaves(
        state_dict_to_flax(model.img_backbone_mod)))
    assert (stats["loaded"], stats["skipped"], stats["unexpected"]) == (
        n_leaves, [], [])
    got = model.img_backbone_mod.state_dict()
    layout = conv.mmcv_layout(conv.HRNET_EXTRA[width])
    attr = {"weight": "weight", "bias": "bias",
            "running_mean": "running_mean", "running_var": "running_var"}
    assert len(got) == len(entries)
    for key, shape in entries:
        prefix, _, leaf = key.rpartition(".")
        mpath, m = layout[prefix]
        name = f"{torch_name(mpath, m)}.{attr[leaf]}"
        assert tuple(got[name].shape) == tuple(shape), key
        assert torch.equal(got[name], torch.from_numpy(sd[key])), key
    # the stride-2 3x3 fuse convs (S2DDownConv in the JAX package's w18)
    s2d = [k for k, s in entries if ".fuse_layers." in k
           and k.endswith(".0.weight") and s[-1] == 3]
    assert len(s2d) == 1 + 4 * 4 + 10 * 3  # stages 2-4: modules x convs


def test_converter_refuses_a_wrong_shape_and_an_unknown_key():
    entries = manifest(18)
    sd = {k: np.zeros(s, np.float32) for k, s in entries}
    bad = dict(sd, **{"conv1.weight": np.zeros((32, 3, 3, 3), np.float32)})
    with pytest.raises(ValueError, match="conv1.weight"):
        conv.convert(bad, conv.HRNET_EXTRA[18])
    with pytest.raises(ValueError, match="map to no HRNet leaf"):
        conv.convert(dict(sd, **{"head.weight": np.zeros(3, np.float32)}),
                     conv.HRNET_EXTRA[18])
    del sd["stage4.2.fuse_layers.3.0.2.1.running_var"]
    with pytest.raises(ValueError, match="not filled"):
        conv.convert(sd, conv.HRNET_EXTRA[18])


@pytest.fixture(scope="module")
def imports(tmp_path_factory):
    """Both packages' imports of a w18 file (with an unexpected subtree and
    an unexpected leaf) and of a w48 file into the same seeded w18 model."""
    tmp = tmp_path_factory.mktemp("pretrain")
    jm, base = jax_variables(18, seed=1)
    out = {}
    for width, seed in ((18, 2), (48, 3)):
        _, blob = jax_variables(width, seed)
        if width == 18:
            blob["params"]["extra_head"] = {"kernel": np.ones((2, 2),
                                                              np.float32)}
            blob["params"]["ConvBNReLU_0"]["stray"] = np.ones(3, np.float32)
        path = str(tmp / f"w{width}.msgpack")
        with open(path, "wb") as f:
            f.write(serialization.msgpack_serialize(blob))
        variables = {"params": {"img_backbone_mod": base["params"]},
                     "batch_stats": {"img_backbone_mod": base["batch_stats"]}}
        records = []

        class Log(logging.Handler):
            def emit(self, record):
                records.append(record.getMessage())

        log = logging.getLogger(f"jax_pretrain_{width}")
        log.addHandler(Log())
        log.setLevel(logging.INFO)
        jv = jload(variables, path, logger=log)
        model = Detector(18)
        load_flax_variables(model.img_backbone_mod, base)
        stats = pretrain.load_hrnet_pretrained(model, path)
        out[width] = dict(jv=jv, stats=stats, model=model, log=records)
    return jm, out


@pytest.mark.parametrize("width", [18, 48])
def test_import_matches_jax(imports, width):
    _, out = imports
    r = out[width]
    jsub = {"params": r["jv"]["params"]["img_backbone_mod"],
            "batch_stats": r["jv"]["batch_stats"]["img_backbone_mod"]}
    want = flax_to_state_dict(r["model"].img_backbone_mod,
                              jax.tree_util.tree_map(np.asarray, jsub))
    got = r["model"].img_backbone_mod.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    s = r["stats"]
    # the JAX log line reports the loaded count, the skipped entries (the
    # first 10) and the number of unexpected keys
    jlog = r["log"]
    assert f"{s['loaded']} tensors" in jlog[0]
    assert [m for m in jlog if "skipped" in m] == [
        f"pretrain skipped (shape mismatch): {x}" for x in s["skipped"][:10]]
    if width == 18:
        assert sorted(s["unexpected"]) == ["ConvBNReLU_0/stray",
                                           "extra_head"]
        assert s["skipped"] == []
        assert jlog[-1] == (f"pretrain: 2 unexpected keys (e.g. "
                            f"{s['unexpected'][:3]})")
    else:
        # the stem and stage 1 (64 channels at every width) load; every
        # branch, transition and fuse leaf is skipped
        assert s["unexpected"] == []
        assert s["loaded"] > 0 and len(s["skipped"]) > 100
        assert all("checkpoint" in x for x in s["skipped"])


def test_forward_after_both_loads(imports):
    jm, out = imports
    r = out[18]
    x = np.random.default_rng(0).uniform(-2, 2, IMG).astype(np.float32)
    jsub = {"params": r["jv"]["params"]["img_backbone_mod"],
            "batch_stats": r["jv"]["batch_stats"]["img_backbone_mod"]}
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        jsub, jnp.asarray(x))
    hr = r["model"].img_backbone_mod.eval()
    with torch.inference_mode():
        got = hr(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == 4
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close_rel(g.permute(0, 2, 3, 1), w, REL_FWD, f"branch {i}")


def test_msgpack_round_trip_is_flax_readable(tmp_path):
    tree = {"params": {"a": {"kernel": np.arange(6, dtype=np.float32)
                             .reshape(2, 3)}},
            "batch_stats": {"a": {"mean": np.zeros(3, np.float64)}}}
    path = str(tmp_path / "t.msgpack")
    pretrain.write_msgpack(tree, path)
    with open(path, "rb") as f:
        back = serialization.msgpack_restore(f.read())
    mine = pretrain.read_msgpack(path)
    for t2 in (back, mine):
        np.testing.assert_array_equal(t2["params"]["a"]["kernel"],
                                      tree["params"]["a"]["kernel"])
        assert t2["batch_stats"]["a"]["mean"].dtype == np.float64
