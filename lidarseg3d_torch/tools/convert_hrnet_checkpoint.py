"""Convert an mmcv/mmseg HRNetV2 state_dict to the flax msgpack that both
packages load as the MSeg3D configs' ``pretrained`` HRNet (the port's
counterpart of tools/convert_hrnet_checkpoint.py).

    python -m lidarseg3d_torch.tools.convert_hrnet_checkpoint IN.pth \
        OUT.msgpack [--width 18|48]

Every mmcv key is mapped by name onto the HRNet's Flax tree (the port's
module names, which are the JAX package's Flax scopes): the stem
(conv1/bn1, conv2/bn2), layer1's Bottlenecks, the transitions, and each
stage's branches and fuse layers, its modules stacked on the scan's
leading axis. That includes the stride-2 3x3 fuse convs of every width;
the JAX package's converter pairs layers in execution order and leaves
w18's space-to-depth stride-2 convs unrecorded (ROADMAP C, reference
fault 1). Every key must map, every Flax leaf must be filled, and every
shape must equal the model's, or the conversion raises.
"""

import argparse

import numpy as np

HRNET_EXTRA = {
    w: dict(
        stage1=dict(num_modules=1, num_branches=1, block="BOTTLENECK",
                    num_blocks=(4,), num_channels=(64,)),
        stage2=dict(num_modules=1, num_branches=2, block="BASIC",
                    num_blocks=(4, 4), num_channels=(w, 2 * w)),
        stage3=dict(num_modules=4, num_branches=3, block="BASIC",
                    num_blocks=(4, 4, 4), num_channels=(w, 2 * w, 4 * w)),
        stage4=dict(num_modules=3, num_branches=4, block="BASIC",
                    num_blocks=(4, 4, 4, 4),
                    num_channels=(w, 2 * w, 4 * w, 8 * w)))
    for w in (18, 48)}


def mmcv_layout(extra):
    """{mmcv module prefix: (Flax module path, scan index or None)} for the
    conv and BN modules of an HRNet of config ``extra``."""
    out = {"conv1": (("ConvBNReLU_0", "Conv_0"), None),
           "bn1": (("ConvBNReLU_0", "MaskedBatchNorm_0"), None),
           "conv2": (("ConvBNReLU_1", "Conv_0"), None),
           "bn2": (("ConvBNReLU_1", "MaskedBatchNorm_0"), None)}

    def cbr(mm_conv, mm_bn, path, m=None):
        out[mm_conv] = (path + ("Conv_0",), m)
        out[mm_bn] = (path + ("MaskedBatchNorm_0",), m)

    s1 = extra["stage1"]
    c = 64
    for b in range(s1["num_blocks"][0]):
        blk = (f"Bottleneck_{b}",)
        for i in range(3):
            cbr(f"layer1.{b}.conv{i + 1}", f"layer1.{b}.bn{i + 1}",
                blk + (f"ConvBNReLU_{i}",))
        if c != s1["num_channels"][0] * 4:
            cbr(f"layer1.{b}.downsample.0", f"layer1.{b}.downsample.1",
                blk + ("ConvBNReLU_3",))
        c = s1["num_channels"][0] * 4
    prev, n_cbr = [c], 2
    for si, key in enumerate(("stage2", "stage3", "stage4")):
        cfg = extra[key]
        nb, chans = cfg["num_branches"], tuple(cfg["num_channels"])
        tr = f"transition{si + 1}"
        for i in range(nb):
            if i < len(prev):
                if prev[i] == chans[i]:
                    continue
                cbr(f"{tr}.{i}.0", f"{tr}.{i}.1", (f"ConvBNReLU_{n_cbr}",))
            else:
                cbr(f"{tr}.{i}.0.0", f"{tr}.{i}.0.1", (f"ConvBNReLU_{n_cbr}",))
            n_cbr += 1
        mod = (f"HRModuleStack_{si}", "scan", "HRModule_0")
        for m in range(cfg["num_modules"]):
            st = f"{key}.{m}"
            k = 0
            for i in range(nb):
                for b in range(cfg["num_blocks"][i]):
                    for j in range(2):
                        cbr(f"{st}.branches.{i}.{b}.conv{j + 1}",
                            f"{st}.branches.{i}.{b}.bn{j + 1}",
                            mod + (f"BasicBlock_{k}", f"ConvBNReLU_{j}"), m)
                    k += 1
            f = 0
            for i in range(nb):
                for j in range(nb):
                    fl = f"{st}.fuse_layers.{i}.{j}"
                    if j > i:
                        cbr(f"{fl}.0", f"{fl}.1", mod + (f"ConvBNReLU_{f}",),
                            m)
                        f += 1
                    for k2 in range(i - j):  # stride-2 3x3 chain, j < i
                        cbr(f"{fl}.{k2}.0", f"{fl}.{k2}.1",
                            mod + (f"ConvBNReLU_{f}",), m)
                        f += 1
        prev = list(chans)
    return out


_LEAVES = {"weight": None, "bias": ("params", "bias"),
           "running_mean": ("batch_stats", "mean"),
           "running_var": ("batch_stats", "var")}


def convert(state_dict, extra):
    """mmcv HRNet state_dict ({key: array}) -> {"params", "batch_stats"}
    Flax tree of the HRNet, strictly (see the module docstring)."""
    import torch

    from ..convert import state_dict_to_flax
    from ..models.img_backbones.hrnet import HRNet

    layout = mmcv_layout(extra)
    with torch.device("meta"):  # shapes only
        want = state_dict_to_flax(HRNet(extra=extra))
    sd = {k: np.asarray(v, np.float32) for k, v in state_dict.items()
          if not k.endswith("num_batches_tracked")}
    if sd and all(k.startswith("backbone.") for k in sd):
        sd = {k[len("backbone."):]: v for k, v in sd.items()}
    out, unmapped, filled = {"params": {}, "batch_stats": {}}, [], set()
    for key, v in sd.items():
        prefix, _, attr = key.rpartition(".")
        if prefix not in layout or attr not in _LEAVES:
            unmapped.append(key)
            continue
        path, m = layout[prefix]
        if attr == "weight":
            conv = path[-1].startswith("Conv")
            coll, leaf = "params", "kernel" if conv else "scale"
            if conv:
                v = v.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        else:
            coll, leaf = _LEAVES[attr]
        full = path + (leaf,)
        node = want[coll]
        for p in full:
            if not isinstance(node, dict) or p not in node:
                raise ValueError(f"{key}: no Flax leaf {coll}/"
                                 f"{'/'.join(full)} in the model")
            node = node[p]
        target = node.shape if m is None else node.shape[1:]
        if tuple(v.shape) != tuple(target):
            raise ValueError(f"{key}: shape {tuple(v.shape)}, the model's "
                             f"{coll}/{'/'.join(full)} expects "
                             f"{tuple(target)}")
        dst = out[coll]
        for p in full[:-1]:
            dst = dst.setdefault(p, {})
        if m is None:
            dst[leaf] = v
        else:
            dst.setdefault(leaf, np.zeros(node.shape, np.float32))[m] = v
        filled.add((coll,) + full + (m,))
    if unmapped:
        raise ValueError(f"{len(unmapped)} mmcv keys map to no HRNet leaf: "
                         f"{unmapped[:10]}")
    missing = []

    def check(w, path):
        for k, v in w.items():
            if isinstance(v, dict):
                check(v, path + (k,))
                continue
            scan = "scan" in path
            for m in range(v.shape[0]) if scan else (None,):
                if path + (k, m) not in filled:
                    missing.append("/".join(path + (k,))
                                   + ("" if m is None else f"[{m}]"))

    for coll in ("params", "batch_stats"):
        check(want[coll], (coll,))
    if missing:
        raise ValueError(f"{len(missing)} HRNet leaves not filled by the "
                         f"state_dict: {missing[:10]}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("input", help="mmcv/mmseg HRNetV2 state_dict (.pth)")
    ap.add_argument("output", help="output .msgpack")
    ap.add_argument("--width", type=int, default=18, choices=[18, 48])
    args = ap.parse_args(argv)

    import torch

    from ..apis.pretrain import write_msgpack

    sd = torch.load(args.input, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    sd = {k: v.numpy() for k, v in sd.items() if hasattr(v, "numpy")}
    write_msgpack(convert(sd, HRNET_EXTRA[args.width]), args.output)
    print(f"wrote {args.output}")
    return args.output


if __name__ == "__main__":
    main()
