"""Activation remat in the port's training step: HRNet's ``with_cp`` and
``ACT_REMAT`` of UNetSCN3D's residual stacks and of the SFFM decoder layers
recompute activations in the backward (utils/remat.py) and change nothing
else. One train step of configs/tests/mini_semkitti_mseg3d.py (all HRNet
stages trainable) with every remat option on, against the same step with
every one off, from the same seeded weights, batch and dropout generator:
every gradient, every updated parameter and every BN running statistic
bit-identical (``torch.equal``), with the point head's dropout off and on.
The dropout draws from an explicit generator that checkpointing does not
restore, so it must stay outside every recomputed region: a draw inside one
raises."""

import copy
from types import SimpleNamespace

import pytest
import torch

from lidarseg3d_torch import synthetic as syn
from lidarseg3d_torch.apis import train as ttrain
from lidarseg3d_torch.models import build_detector
from lidarseg3d_torch.models.point_heads.mseg3d_head import PointSegMSeg3DHead
from lidarseg3d_torch.solver.optim import build_one_cycle_optimizer
from lidarseg3d_torch.utils import remat

from test_torch_port_support import mini_config, one_torch_thread


def _model_cfg(on, dp):
    cfg = mini_config()
    m = copy.deepcopy(cfg.model.to_dict())
    m["img_backbone"]["with_cp"] = on
    m["backbone"]["model_cfg"]["ACT_REMAT"] = on
    m["point_head"]["model_cfg"].update(ACT_REMAT=on, DP_RATIO=dp)
    return cfg, m


def _step(on, dp):
    cfg, mcfg = _model_cfg(on, dp)
    pcr, vsz = cfg.point_cloud_range, cfg.voxel_size
    model = build_detector(mcfg, device="cpu", seed=2)
    assert model.img_backbone_mod.stages[0][1].remat is on
    assert model.backbone_mod.SparseBasicBlockStack_0.remat is on
    assert model.point_head_mod.SemanticFeatureFusionModule_0.remat is on
    opt, _ = build_one_cycle_optimizer(
        dict(type="adam", wd=0.01), dict(lr_max=1e-3), 10)
    state = ttrain.create_train_state(model, opt, seed=4)
    batch = syn.synthetic_mseg3d_batch(2, 1024, 1024, img_hw=(64, 128),
                                       seed=3, with_labels=True, pcr=pcr,
                                       vsz=vsz)
    step = ttrain.make_train_step(model, opt, syn.grid_shape(pcr, vsz))
    _, ldict = step(state, ttrain.example_to_device(batch, "cpu"))
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    return ldict, grads, model.state_dict()


@pytest.mark.parametrize("dp", [0.0, 0.25], ids=["dropout off",
                                                  "dropout on"])
def test_remat_changes_no_gradient_and_no_statistic(dp):
    l_off, g_off, sd_off = _step(False, dp)
    l_on, g_on, sd_on = _step(True, dp)
    for k in l_off:
        assert torch.equal(l_off[k], l_on[k]), k
    assert set(g_off) == set(g_on)
    for k in g_off:
        assert torch.equal(g_off[k], g_on[k]), k
    stats = [k for k in sd_off if k.endswith(("running_mean", "running_var"))]
    assert len(stats) > 50
    for k in sd_off:
        assert torch.equal(sd_off[k], sd_on[k]), k


def test_dropout_refuses_a_recomputed_region():
    head = PointSegMSeg3DHead.__new__(PointSegMSeg3DHead)
    torch.nn.Module.__init__(head)
    head.dp_ratio = 0.25
    gen = torch.Generator().manual_seed(0)
    batch = {"conv_point_features": torch.ones(1, 4, 2, requires_grad=True),
             "conv_structure": SimpleNamespace(valid_mask=lambda: None),
             "point_valid": None}

    def region(x):
        batch["conv_point_features"] = x
        return head(batch, generator=gen)

    head.train()
    with pytest.raises(RuntimeError, match="outside every recomputed"):
        remat.remat(region, batch["conv_point_features"])
    assert remat.phase() is None
