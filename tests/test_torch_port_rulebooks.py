"""lidarseg3d_torch structures and rulebooks against the JAX package, bit
for bit: the UNetSCN3D chain of structures (decimation and union output
sites), rank tables and all 10 [K, B, V] rulebooks (subm, strided,
inverse), on a scaled-down copy of the SemanticKITTI bench grid (same
voxel size, 12.8 m instead of 51.2 m across), B=2."""

import numpy as np
import jax.numpy as jnp
import pytest

from __graft_entry__ import _synthetic_batch
from lidarseg3d_tpu.ops import sparse as jsp
from lidarseg3d_torch import synthetic as syn
from lidarseg3d_torch.ops import sparse as tsp

from _torch_port_helpers import n, t

PCR_SMALL = (-6.4, -6.4, -4.0, 6.4, 6.4, 2.0)
V, N = 4096, 6000


@pytest.fixture(scope="module")
def scans():
    jb = _synthetic_batch(2, V, N, seed=5, pcr=PCR_SMALL)
    tb = syn.synthetic_batch(2, V, N, seed=5, pcr=PCR_SMALL)
    for k in ("voxels", "coordinates", "num_points", "num_voxels", "points"):
        np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
    return jb, syn.grid_shape(PCR_SMALL)


def _chain(sp, s1, rule, V):
    """The structure/rulebook chain of UNetSCN3D.__call__."""
    out = {}
    t1 = sp.dense_table(s1)
    out["t1"] = t1.packed
    out["subm1"] = sp.build_subm_rulebook(s1, table=t1)
    s2 = sp.downsample_structure(s1, 2, capacity=V // 2, padding=1,
                                 rule=rule)
    out["down2"] = sp.build_strided_rulebook(s1, s2, 3, 2, 1, table=t1)
    t2 = sp.dense_table(s2)
    out["subm2"] = sp.build_subm_rulebook(s2, table=t2)
    out["inv2"] = sp.build_inverse_rulebook(s2, s1, 3, 2, 1, table=t2)
    s3 = sp.downsample_structure(s2, 2, capacity=V // 4, padding=1,
                                 rule=rule)
    t3 = sp.dense_table(s3)
    out["down3"] = sp.build_strided_rulebook(s2, s3, 3, 2, 1, table=t2)
    out["subm3"] = sp.build_subm_rulebook(s3, table=t3)
    out["inv3"] = sp.build_inverse_rulebook(s3, s2, 3, 2, 1, table=t3)
    s4 = sp.downsample_structure(s3, 2, capacity=int(V * 0.15),
                                 padding=(0, 1, 1), rule=rule)
    t4 = sp.dense_table(s4)
    out["down4"] = sp.build_strided_rulebook(s3, s4, 3, 2, (0, 1, 1),
                                             table=t3)
    out["subm4"] = sp.build_subm_rulebook(s4, table=t4)
    out["inv4"] = sp.build_inverse_rulebook(s4, s3, 3, 2, (0, 1, 1),
                                            table=t4)
    for i, s in enumerate((s2, s3, s4), start=2):
        out[f"s{i}.coords"] = s.coords
        out[f"s{i}.num"] = s.num_voxels
        out[f"s{i}.shape"] = s.spatial_shape
    out["t4"] = t4.packed
    out["centers"] = sp.voxel_centers(s1, (0.2, 0.2, 0.3), PCR_SMALL)
    return out


@pytest.mark.parametrize("rule", ["decimation", "union"])
def test_structure_chain_and_rulebooks_bit_exact(scans, rule):
    b, ishape = scans
    js1 = jsp.build_structure(jnp.asarray(b["coordinates"]),
                              jnp.asarray(b["num_voxels"]), ishape)
    ts1 = tsp.build_structure(t(b["coordinates"]), t(b["num_voxels"]),
                              ishape)
    want = _chain(jsp, js1, rule, V)
    got = _chain(tsp, ts1, rule, V)
    assert int(want["s4.num"].min()) > 0
    for k in want:
        if k.endswith(".shape"):
            assert tuple(got[k]) == tuple(want[k]), k
        elif k == "centers":
            np.testing.assert_allclose(n(got[k]), n(want[k]), rtol=1e-6,
                                       atol=1e-6)
        else:
            assert n(got[k]).shape == n(want[k]).shape, k
            np.testing.assert_array_equal(n(got[k]), n(want[k]), err_msg=k)
    # every rulebook is [27, B, V_out] with misses at B * V_in
    assert tuple(got["inv2"].shape) == (27, 2, V)


def test_unique_coords_matches_jax(scans):
    """Dense-dedup (small grid) and sort (large grid) formulations of the
    JAX package both equal the port's sort formulation."""
    rng = np.random.default_rng(0)
    c = rng.integers(0, 6, (2, 500, 3)).astype(np.int32)
    valid = rng.random((2, 500)) < 0.8
    for shape in ((6, 6, 6), (60, 60, 60)):
        for cap in (50, 400):
            want = jsp.coord_ops.unique_coords(jnp.asarray(c),
                                               jnp.asarray(valid), shape, cap)
            got = tsp.unique_coords(t(c), t(valid), shape, cap)
            for w, g in zip(want, got):
                np.testing.assert_array_equal(n(g), n(w))
