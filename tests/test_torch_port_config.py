"""lidarseg3d_torch's own copies of the config loader and the registries:
the published SemanticKITTI MSeg3D config file loads to the same dict as
with the JAX package's loader, and the port builds that model with the
parameters of the bench model (same widths; only the grid differs)."""

from pathlib import Path

import pytest

from lidarseg3d_tpu.utils.config import Config as JConfig
from lidarseg3d_torch.models import build_detector
from lidarseg3d_torch.synthetic import mseg3d_model_cfg
from lidarseg3d_torch.utils.config import Config as TConfig

CFG = (Path(__file__).resolve().parents[1] / "configs" / "semantickitti"
       / "MSeg3D" / "semkitti_avgvfe_unetscn3d_hrnetw18_lr1en2_e12.py")


def test_config_loader_matches_jax_package():
    got, want = TConfig.fromfile(str(CFG)), JConfig.fromfile(str(CFG))
    assert got.to_dict() == want.to_dict()
    assert got.model.backbone.model_cfg.SCALING_RATIO == 2
    assert got.text == want.text


def test_build_detector_from_published_config():
    model = build_detector(TConfig.fromfile(str(CFG)).model, device="cpu")
    bench = build_detector(mseg3d_model_cfg(ratio=2), device="cpu")
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    want = {k: tuple(v.shape) for k, v in bench.state_dict().items()}
    assert got == want
    assert not model.training


def test_unknown_type_raises():
    cfg = mseg3d_model_cfg(ratio=1, small_hrnet=True)
    cfg["type"] = "NoSuchNet"
    with pytest.raises(KeyError, match="NoSuchNet"):
        build_detector(cfg, device="cpu")
