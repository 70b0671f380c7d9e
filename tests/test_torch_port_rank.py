"""lidarseg3d_torch rank-table pack and lookup (the plain versions of the
rank_pack and rank_lookup kernels) against the JAX package: the Pallas
kernels in interpret mode and the XLA formulations, bit for bit."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lidarseg3d_tpu.ops import coords as jco
from lidarseg3d_tpu.ops import pallas_lookup as plk
from lidarseg3d_tpu.ops import pallas_rank
from lidarseg3d_tpu.ops import sparse as jsp
from lidarseg3d_torch.ops import coords as tco
from lidarseg3d_torch.ops.rank_lookup import gather_cells, gather_cells_plain
from lidarseg3d_torch.ops.rank_pack import (pack_rank_table,
                                            pack_rank_table_plain)

from _torch_port_helpers import n, t


@pytest.mark.parametrize("nce,density", [
    (8192, 0.1),          # exactly one pack block
    (3 * 8192 + 17, 0.3),  # several blocks and a ragged tail
    (50_000, 0.01),       # mostly empty blocks
])
def test_pack_matches_pallas_kernel(nce, density):
    rng = np.random.default_rng(nce)
    act = (rng.random(nce) < density).astype(np.int8)
    act[0] = act[-1] = 1  # table-edge neighbour bits
    want = pallas_rank.pack_rank_table(jnp.asarray(act), interpret=True)
    got = pack_rank_table(t(act))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(n(got), n(want))
    np.testing.assert_array_equal(n(pack_rank_table_plain(t(act))), n(want))


def _coords(rng, shape, nvox, V):
    Z, Y, X = shape
    keys = np.sort(rng.choice(Z * Y * X, size=nvox, replace=False))
    c = np.stack([keys // (Y * X), (keys // X) % Y, keys % X], -1)
    return np.concatenate([c, np.full((V - nvox, 3), -1)]).astype(np.int32)


def test_build_rank_table_matches_xla():
    """Activity scatter + pack == coords.build_rank_table (XLA blocked
    prefix), B=2 with padded rows, on a grid of more than one pack block."""
    rng = np.random.default_rng(0)
    shape, V = (5, 40, 60), 3000
    coords = np.stack([_coords(rng, shape, 2500, V),
                       _coords(rng, shape, 1800, V)])
    num = np.array([2500, 1800], np.int32)
    want = jco.build_rank_table(jnp.asarray(coords), jnp.asarray(num), shape,
                                use_pallas=False)
    got = tco.build_rank_table(t(coords), t(num), shape)
    assert got.spatial_shape == want.spatial_shape
    np.testing.assert_array_equal(n(got.packed), n(want.packed))


@pytest.mark.parametrize("nce", [50_000, plk.LOOKUP_VMEM_BUDGET // 4 + 9000])
def test_lookup_matches_pallas_kernel(nce):
    """Sorted query stream through lookup_gather (interpret mode): the
    VMEM-resident kernel and, above the 12 MB budget, the HBM variant."""
    rng = np.random.default_rng(1)
    table = rng.integers(0, 2**28, nce).astype(np.int32)
    cells = np.sort(rng.choice(nce, size=2048, replace=False)).astype(
        np.int32)
    want = plk.lookup_gather(jnp.asarray(table), jnp.asarray(cells),
                             interpret=True)
    got = gather_cells(t(table)[None], t(cells)[None, None])
    np.testing.assert_array_equal(n(got)[0, 0], n(want))


def test_grouped_gather_matches_xla():
    """The grouped gather against the JAX package's _gather_cells on
    [G, B, V] query groups (B=2, unsorted cells)."""
    rng = np.random.default_rng(2)
    packed = rng.integers(0, 2**28, (2, 30_000)).astype(np.int32)
    cell = rng.integers(0, 30_000, (9, 2, 700)).astype(np.int32)
    inb = np.ones(cell.shape, bool)
    want = jsp._gather_cells(jnp.asarray(packed), jnp.asarray(cell),
                             jnp.asarray(inb))
    got = gather_cells(t(packed), t(cell))
    np.testing.assert_array_equal(n(got), n(want))
    np.testing.assert_array_equal(
        n(gather_cells_plain(t(packed), t(cell))), n(want))


def test_lookup_rank_matches_jax():
    rng = np.random.default_rng(3)
    shape, V = (4, 20, 30), 1000
    coords = _coords(rng, shape, 900, V)[None]
    num = np.array([900], np.int32)
    jt = jco.build_rank_table(jnp.asarray(coords), jnp.asarray(num), shape)
    tt = tco.build_rank_table(t(coords), t(num), shape)
    q = rng.integers(-2, 32, (1, 4000, 3)).astype(np.int32)
    ev = rng.random((1, 4000)) < 0.9
    wi, wf = jco.lookup_rank(jt, jnp.asarray(q), jnp.asarray(ev))
    gi, gf = tco.lookup_rank(tt, t(q), t(ev))
    np.testing.assert_array_equal(n(gf), n(wf))
    np.testing.assert_array_equal(n(gi)[n(gf)], n(wi)[n(wf)])
