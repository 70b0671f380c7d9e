"""Shared helpers of the tests that hold lidarseg3d_torch against the JAX
package (tests/test_torch_port_*.py): random Flax variables from a model's
init shapes, and numpy/torch conversions. Both sides always get the same
numpy inputs."""

import jax
import numpy as np
import torch

_SCAN_SCOPES = ("blocks", "scan", "SFFMDecoderLayer_0")


def init_shapes(module, *args, **kwargs):
    """Variable shapes of ``module.init`` without running it."""
    return jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))


def random_variables(shapes, seed):
    """Random Flax variables with the given shapes: fan-in scaled kernels,
    non-trivial BN/LayerNorm scales and biases, and non-trivial BN running
    statistics (so the batch_stats mapping is exercised)."""
    rng = np.random.default_rng(seed)

    def fill(path, sds):
        names = [str(getattr(p, "key", p)) for p in path]
        leaf, shape = names[-1], tuple(sds.shape)
        if names[0] == "batch_stats":
            v = (rng.normal(0.0, 0.2, shape) if leaf == "mean"
                 else rng.uniform(0.5, 2.0, shape))
        elif leaf == "kernel":
            scanned = any(n in _SCAN_SCOPES for n in names)
            fan = int(np.prod(shape[1 if scanned else 0:-1]))
            v = rng.uniform(-1.0, 1.0, shape) * np.sqrt(3.0 / fan)
        elif leaf == "scale":
            v = rng.uniform(0.5, 1.5, shape)
        else:
            v = rng.normal(0.0, 0.1, shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, dict(shapes))


def t(a):
    """numpy (or JAX) array -> CPU torch tensor."""
    return torch.from_numpy(np.array(a))


def n(x):
    """torch tensor or JAX array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_close_rel(got, want, rel, what=""):
    """max |got - want| <= rel * max |want| (fp32 order-of-summation)."""
    got, want = n(got).astype(np.float64), n(want).astype(np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= rel * scale, f"{what}: max abs err {err} > {rel} * {scale}"
