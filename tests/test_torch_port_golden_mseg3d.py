"""lidarseg3d_torch's flagship MSeg3D forward against the float64 oracle
chain of tests/test_golden_mseg3d.py ``test_flagship_matches_float64_oracle``
(torch dense convs and numpy linear algebra, independent of both
packages), on that test's example: B=2, two cameras of 32x64 (the
recorded HRNet input), a 16x16 BEV at 0.5 m with 8(+1) z slabs, 260
points and capacity 320, OUTPUT_SITES="union",
OOV_COMPLETION="pseudo_camera", evaluation mode.

The port's model is that test's config with its seeded init, BN running
statistics spread, and the recorded HRNet weights grafted in through the
port's importer (tools/convert_hrnet_checkpoint.py); every parameter and
statistic reaches the oracles through ``convert.state_dict_to_flax`` (the
attention's DenseGeneral kernels reshaped back to [E, H, dh] /
[H, dh, E]). Held, at the JAX test's tolerances in fp32 (rtol = atol):
image logits 2e-4 (``o_fcn_head``), conv_point_features at the active
sites 3e-4 (``o_improved_mean_vfe`` -> ``o_unet_eval``), voxel logits 3e-4
(``o_mlp_head``), point logits 5e-4 (``o_grid27_interpolate``,
``o_grid_sample``, the completion and GF phase, ``o_sffm``); in float64
each within 1e-8 of max |oracle|, the point logits within 1e-7: the
devoxelization computes its voxel centres in fp32 whatever the features'
dtype, as the JAX package does (1.3e-8 of max read).

The 3-NN devoxelization's indices (the port's grid-27 candidates, top 3
by distance) are held exactly against a brute-force search
(``exact_three_nn``, lidarseg3d_tpu/ops/interpolate.py:337, copied into
tests/_torch_port_oracles.py): over the voxels of each point's 3x3x3
neighbourhood, the port's neighbours, their order and which slots stay
empty equal the search's; over every voxel of the sample, they equal the
search's up to its first neighbour outside the neighbourhood. They are not
the exact 3-NN everywhere: on this sparse, anisotropic grid (about 12% of
the cells active, voxels 0.5 x 0.5 x 0.25 m) a voxel two slabs away in z
is often nearer than a diagonal neighbour, and 244 of the 520 valid
points have another neighbour set (347 of 1560 slots differ; the
devoxelized features then differ from an exact 3-NN interpolation by up
to 7.6% of their max, the point logits by 0.74%). The JAX package's
grid-27 devoxelization does the same; the original three_nn is exact
(ROADMAP §C, reference caveat 27)."""

import numpy as np
import pytest
import torch

from lidarseg3d_torch.convert import load_flax_variables, state_dict_to_flax
from lidarseg3d_torch.models import build_detector
from lidarseg3d_torch.ops import interpolate as interp

from _torch_port_oracles import exact_three_nn
from test_golden_mseg3d import (B, NCAM, NCLS, PCR, VCAP, VSZ,
                                make_example, model_cfg, o_bn_eval,
                                o_fcn_head, o_grid27_interpolate,
                                o_grid_sample, o_improved_mean_vfe,
                                o_linear, o_mlp_head, o_sffm, o_softmax,
                                o_unet_eval)
from test_torch_port_golden_hrnet import (  # noqa: F401
    npz, recorded_hrnet_variables)
from test_torch_port_support import one_torch_thread  # noqa: F401

TOL = {"image_logits": 2e-4, "conv_point_features": 3e-4,
       "voxel_logits": 3e-4, "out_logits": 5e-4}
REL64 = {"image_logits": 1e-8, "conv_point_features": 1e-8,
         "voxel_logits": 1e-8, "out_logits": 1e-7}
ATTENTION = ("query", "key", "value", "out")


def flax_tree(model, n_head=4):
    """The model's variables as the Flax tree the oracles read."""
    v = state_dict_to_flax(model)
    sffm = v["params"]["point_head_mod"]["SemanticFeatureFusionModule_0"]
    att = sffm["SFFMDecoderLayer_0"]["MultiHeadDotProductAttention_0"]
    for name in ATTENTION:
        k, b = att[name]["kernel"], att[name]["bias"]  # [L, in, out], [L, E]
        L, E = b.shape
        if name == "out":
            att[name]["kernel"] = k.reshape(L, n_head, E // n_head, E)
        else:
            att[name]["kernel"] = k.reshape(L, E, n_head, E // n_head)
            att[name]["bias"] = b.reshape(L, n_head, E // n_head)
    return v["params"], v["batch_stats"]


def oracle_chain(ex, P, S, hr_outs):
    """test_flagship_matches_float64_oracle's chain -> the float64
    image logits, conv_point_features at each sample's active sites,
    voxel logits and point logits."""
    img_feats, img_logits, cam_emb = o_fcn_head(
        hr_outs, P["img_head_mod"], S["img_head_mod"])
    vox, npv = ex["voxels"], ex["num_points"]
    coords, nvox = ex["coordinates"], ex["num_voxels"]
    vfe = o_improved_mean_vfe(vox, npv)
    Z, Y, X = ex["input_shape"]
    up1_sites = []
    for b in range(B):
        dense = np.zeros((1, Z, Y, X, 12))
        n = int(nvox[b])
        act = coords[b][:n]
        dense[0, act[:, 0], act[:, 1], act[:, 2]] = vfe[b, :n]
        m1 = torch.zeros((1, 1, Z, Y, X), dtype=torch.float64)
        m1[0, 0, act[:, 0], act[:, 1], act[:, 2]] = 1.0
        up1 = o_unet_eval(dense, m1, P["backbone_mod"], S["backbone_mod"])
        d = up1[0].permute(1, 2, 3, 0).numpy()
        up1_sites.append(d[act[:, 0], act[:, 1], act[:, 2]])

    Ph, Sh = P["point_head_mod"], S["point_head_mod"]
    feats = np.zeros((B, VCAP, 16))
    for b in range(B):
        feats[b, :int(nvox[b])] = up1_sites[b]
    vmask = np.arange(VCAP)[None, :] < nvox[:, None]
    voxel_logits = o_mlp_head(feats, Ph["MLPHead_0"], Sh["MLPHead_0"],
                              fcs=[16])
    pts = ex["points"][..., :3]
    pvalid = ex["point_valid"]
    p_lidar0 = o_grid27_interpolate(pts, pvalid, coords, nvox, feats, VSZ,
                                    PCR)
    p_lidar = np.maximum(o_bn_eval(o_linear(p_lidar0, Ph["TorchLinear_0"]),
                                   Ph["MaskedBatchNorm_0"],
                                   Sh["MaskedBatchNorm_0"], eps=1e-6), 0.0)
    cuv = ex["points_cuv"]
    in_view = (cuv[..., 0] > 0.5) & pvalid
    f5 = img_feats.reshape(B, NCAM, *img_feats.shape[1:])
    p_cam0 = o_grid_sample(f5.astype(np.float64), cuv)
    p_cam = np.maximum(o_bn_eval(o_linear(p_cam0, Ph["TorchLinear_1"]),
                                 Ph["MaskedBatchNorm_1"],
                                 Sh["MaskedBatchNorm_1"], eps=1e-6), 0.0)
    p_pcam = o_mlp_head(p_lidar, Ph["MLPHead_1"], Sh["MLPHead_1"],
                        fcs=[16, 16])
    p_ccam = np.where(in_view[..., None], p_cam, p_pcam) * pvalid[..., None]
    geo = o_linear(np.concatenate([p_lidar, p_ccam], -1),
                   Ph["TorchLinear_2"])
    geo = np.maximum(o_bn_eval(geo, Ph["MaskedBatchNorm_2"],
                               Sh["MaskedBatchNorm_2"], eps=1e-5), 0.0)
    masked = np.where(vmask[..., None], voxel_logits, -np.inf)
    lidar_emb = np.einsum("bvc,bve->bce", o_softmax(masked, axis=1), feats)
    fused = o_sffm(geo, cam_emb, lidar_emb,
                   Ph["SemanticFeatureFusionModule_0"])
    return dict(image_logits=img_logits, conv_point_features=up1_sites,
                voxel_logits=np.where(vmask[..., None], voxel_logits, 0.0),
                out_logits=np.where(pvalid[..., None],
                                    o_linear(fused, Ph["TorchLinear_3"]),
                                    0.0))


@pytest.fixture(scope="module")
def golden(npz):
    ex = {k: (v if k == "input_shape" else np.array(v))
          for k, v in make_example(npz).items()}
    model = build_detector(model_cfg(), device="cpu", seed=11)
    load_flax_variables(model.img_backbone_mod,
                        recorded_hrnet_variables(npz))
    gen = torch.Generator().manual_seed(12)
    with torch.no_grad():  # spread the BN statistics outside the HRNet
        for k, v in model.state_dict().items():
            if k.startswith("img_backbone_mod"):
                continue
            if k.endswith("running_var"):
                v.copy_(0.5 + 1.5 * torch.rand(v.shape, generator=gen))
            elif k.endswith("running_mean"):
                v.copy_(0.2 * torch.randn(v.shape, generator=gen))
    P, S = flax_tree(model)
    hr_outs = [npz[f"out{i}"] for i in range(4)]
    return dict(ex=ex, model=model.eval(),
                want=oracle_chain(ex, P, S, hr_outs))


def port_forward(golden, dtype, record=None):
    """The port's forward in ``dtype`` -> (ret, batch); ``record`` (a
    list) receives the devoxelization's candidates."""
    ex = {k: v if k == "input_shape" else torch.from_numpy(v)
          for k, v in golden["ex"].items()}
    for k in ("voxels", "points", "images", "points_cuv"):
        ex[k] = ex[k].to(dtype)
    model = golden["model"].to(dtype)
    orig = interp._interp_from_candidates

    def spy(cand_d, cand_i, *a, **kw):
        record.append((cand_d, cand_i))
        return orig(cand_d, cand_i, *a, **kw)

    try:
        if record is not None:
            interp._interp_from_candidates = spy
        return model(ex)
    finally:
        interp._interp_from_candidates = orig
        model.float()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_flagship_matches_float64_oracle(golden, dtype):
    ret, bat = port_forward(golden, dtype)
    want = golden["want"]
    ex = golden["ex"]
    vmask = np.arange(VCAP)[None, :] < ex["num_voxels"][:, None]
    pvalid = ex["point_valid"]
    got = {
        "image_logits": ret["image_logits"],
        "conv_point_features": [bat["conv_point_features"][b, :int(n)]
                                for b, n in enumerate(ex["num_voxels"])],
        "voxel_logits": np.where(vmask[..., None],
                                 ret["voxel_logits"].numpy(), 0.0),
        "out_logits": np.where(pvalid[..., None], ret["out_logits"].numpy(),
                               0.0)}
    assert ret["out_logits"].dtype == dtype
    assert ret["out_logits"].shape[-1] == NCLS
    for name, tol in TOL.items():
        gs = got[name] if isinstance(got[name], list) else [got[name]]
        ws = want[name] if isinstance(want[name], list) else [want[name]]
        for g, w in zip(gs, ws):
            g = np.asarray(g, np.float64)
            assert g.shape == w.shape and np.abs(w).max() > 0.05, name
            if dtype == torch.float32:
                np.testing.assert_allclose(g, w, rtol=tol, atol=tol,
                                           err_msg=name)
            else:
                err = np.abs(g - w).max()
                assert err <= REL64[name] * np.abs(w).max(), (name, err)


def test_three_nn_indices_against_brute_force(golden):
    rec = []
    port_forward(golden, torch.float32, record=rec)
    (cand_d, cand_i), = rec
    best_d, arg = interp._small_topk(cand_d, 3)
    best_i = torch.gather(cand_i, 0, arg).numpy()  # [3, B, N] global rows
    best_d = best_d.numpy()
    ex = golden["ex"]
    vs, org = np.asarray(VSZ), np.asarray(PCR[:3])
    slots = differ = 0
    for b in range(B):
        n = int(ex["num_voxels"][b])
        czyx = ex["coordinates"][b][:n]
        centers = (czyx[:, ::-1].astype(np.float64) + 0.5) * vs + org
        valid = ex["point_valid"][b]
        pts = ex["points"][b][valid, :3].astype(np.float64)
        own = np.floor((pts - org) / vs).astype(int)[:, ::-1]
        port_i = best_i[:, b][:, valid].T - b * VCAP  # [n_valid, 3]
        port_d = best_d[:, b][:, valid].T
        _, glob = exact_three_nn(pts, centers, np.ones(n, bool))
        for p in range(len(pts)):
            near = np.abs(czyx - own[p]).max(1) <= 1  # 3x3x3 neighbourhood
            d2, idx = exact_three_nn(pts[p:p + 1], centers, near)
            found = np.isfinite(d2[0])
            assert found[0]  # a point's own voxel is active
            np.testing.assert_array_equal(np.isfinite(port_d[p]), found)
            np.testing.assert_array_equal(port_i[p][found], idx[0][found])
            np.testing.assert_allclose(port_d[p][found], d2[0][found],
                                       rtol=1e-5, atol=1e-6)
            # against every voxel: equal up to the first of the oracle's
            # neighbours that lies outside the neighbourhood
            out = ~near[glob[p]]
            k = int(np.argmax(out)) if out.any() else 3
            np.testing.assert_array_equal(port_i[p][:k], glob[p][:k])
            slots += 3
            differ += int((port_i[p] != glob[p]).sum())
    assert slots == 3 * int(ex["point_valid"].sum()) and differ > 0
