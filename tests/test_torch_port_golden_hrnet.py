"""lidarseg3d_torch's HRNet against the recorded float64 forward of the
original torch HRNet module (tests/data/golden_hrnet_tiny.npz, recorded
by tools/parity/record_golden_hrnet.py from det3d's hrnet.py with mmcv
stubbed: the mmcv-layout state_dict, the input and the four outputs), as
tests/test_golden_mseg3d.py ``test_hrnet_matches_reference_golden`` holds
the JAX package:

the port's HRNet at the recording's TINY_HRNET widths, its weights and BN
statistics imported from the npz's state_dict through the port's own
importer (``tools/convert_hrnet_checkpoint.convert``, then
``convert.load_flax_variables``), in evaluation mode on the recorded
input. Each output scale matches the recording within rtol = atol = 2e-4
in fp32 (the JAX test's limit) and within 1e-6 of max |recording| in
float64 (the state_dict is fp32, the recording's arithmetic float64)."""

import os

import numpy as np
import pytest
import torch

from lidarseg3d_torch.convert import load_flax_variables
from lidarseg3d_torch.models import build_img_backbone
from lidarseg3d_torch.tools.convert_hrnet_checkpoint import convert

from test_golden_mseg3d import TINY_HRNET
from test_torch_port_support import one_torch_thread  # noqa: F401

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


@pytest.fixture(scope="module")
def npz():
    return np.load(os.path.join(DATA, "golden_hrnet_tiny.npz"))


def recorded_hrnet_variables(npz):
    """The npz's mmcv state_dict through the port's importer -> the Flax
    variables of an HRNet at TINY_HRNET."""
    sd = {k[3:]: np.asarray(npz[k], np.float32)
          for k in npz.files if k.startswith("sd/")}
    return convert(sd, TINY_HRNET)


def golden_hrnet(npz):
    """The port's HRNet at TINY_HRNET with the recorded weights."""
    model = build_img_backbone(dict(type="HRNet", extra=TINY_HRNET))
    load_flax_variables(model, recorded_hrnet_variables(npz))
    return model.eval()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_hrnet_matches_reference_golden(npz, dtype):
    model = golden_hrnet(npz).to(dtype)
    with torch.no_grad():
        ys = model(torch.from_numpy(npz["input_nchw"]).to(dtype))
    assert len(ys) == 4
    for i, y in enumerate(ys):
        want = npz[f"out{i}"]
        got = y.numpy().astype(np.float64)
        assert got.shape == want.shape and y.dtype == dtype
        if dtype == torch.float32:
            np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4,
                                       err_msg=f"HRNet output scale {i}")
        else:
            err = np.abs(got - want).max()
            assert err <= 1e-6 * np.abs(want).max(), (i, err)
