"""lidarseg3d_torch's UNetSCN3D against the float64 dense-conv oracle of
tests/test_golden_unet.py (torch dense convs masked to spconv's site
sets, a reconstruction independent of both packages; its dataflow copied
into tests/_torch_port_oracles.py), on that test's input: (16, 12, 12)
grid, capacity 512, 6 input channels, r=1, OUTPUT_SITES="union",
DOWN_CAPACITY_RATIOS=(1, 1, 1), training mode (BN on the batch statistics
of the active sites).

The port's weights (its seeded init, BN scales and biases spread) reach
the oracle through ``convert.state_dict_to_flax``. Every decoder stage
(x_conv4, x_up4, x_up3, x_up2) and the output x_up1 are compared at their
stored site sets: in float64, which the port's plain path takes, within
1e-9 of the oracle (max abs error relative to max |oracle|, a fraction of
the JAX test's 2e-4); in fp32 within that test's rtol = atol = 2e-4."""

import numpy as np
import pytest
import torch

from lidarseg3d_torch.convert import state_dict_to_flax
from lidarseg3d_torch.models import build_backbone
from lidarseg3d_torch.models.layers import init_parameters
from lidarseg3d_torch.ops import sparse as sp

from _torch_port_oracles import unet_train_oracle
from test_golden_unet import CIN, SHAPE, VCAP, gather_sites
from test_sparse_conv import make_random_sparse
from test_torch_port_support import one_torch_thread  # noqa: F401

CFG = dict(type="UNetSCN3D", num_input_features=CIN,
           point_cloud_range=(0, 0, 0, 1, 1, 1), voxel_size=(0.1, 0.1, 0.1),
           model_cfg=dict(SCALING_RATIO=1, OUTPUT_SITES="union",
                          DOWN_CAPACITY_RATIOS=(1.0, 1.0, 1.0)))
STAGES = (("x_conv4", "x_conv4"), ("x_up4", "x_conv3"), ("x_up3", "x_conv2"),
          ("x_up2", "x_conv1"))


@pytest.fixture(scope="module")
def oracle():
    rng = np.random.default_rng(3)
    coords, feats, nums, dense_np = make_random_sparse(
        rng, 1, VCAP, SHAPE, CIN, density=0.08)
    model = build_backbone(dict(CFG))
    gen = torch.Generator().manual_seed(7)
    init_parameters(model, gen)
    with torch.no_grad():  # spread the BN scales and biases
        for name, p in model.named_parameters():
            if "MaskedBatchNorm" in name:
                p.add_(0.3 * torch.randn(p.shape, generator=gen))
    P = state_dict_to_flax(model)["params"]
    want = unet_train_oracle(dense_np, coords[0][: nums[0]], P)
    return dict(coords=coords, feats=feats, nums=nums, model=model,
                want=want)


@pytest.mark.parametrize("dtype,rel", [(torch.float64, 1e-9),
                                       (torch.float32, None)])
def test_unet_matches_float64_dense_oracle(oracle, dtype, rel):
    model = oracle["model"].to(dtype).train()
    try:
        st = sp.SparseTensor(
            structure=sp.build_structure(torch.from_numpy(oracle["coords"]),
                                         torch.from_numpy(oracle["nums"]),
                                         SHAPE),
            features=torch.from_numpy(oracle["feats"]).to(dtype))
        with torch.no_grad():
            out = model(st)
    finally:
        model.float()
    ms = out["multi_scale_3d_features"]
    got = [(name, ms[key].features, ms[key].structure)
           for name, key in STAGES]
    got.append(("x_up1", out["conv_point_features"], st.structure))
    for name, feats, struct in got:
        assert feats.dtype == dtype, name
        n = int(struct.num_voxels[0])
        assert n > 0, name
        g = feats[0, :n].numpy().astype(np.float64)
        w = gather_sites(oracle["want"][name], struct)
        assert np.abs(w).max() > 0.1, name
        if rel is None:  # the JAX test's fp32 tolerance
            np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-4,
                                       err_msg=name)
        else:
            err = np.abs(g - w).max()
            assert err <= rel * np.abs(w).max(), (name, err)
