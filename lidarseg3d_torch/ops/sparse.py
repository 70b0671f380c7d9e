"""Sparse 3D convolution as gather -> GEMM over key-sorted voxel sets
(PyTorch port of lidarseg3d_tpu/ops/sparse.py: rank-table and sorted-keys
lookups, rulebooks, convs).

For every kernel offset each output voxel has AT MOST ONE input partner,
so a sparse conv is K gathers + K matmuls with no scatter:

    out[b, j] = sum_k  W[k] @ features[b, lookup(out_coord[b, j] -> tap k)]

Rulebooks are [K, B, V] global flat rows into the ``flat_features`` table
[B*V_in + 1, C]; a miss is B*V_in, the trailing zero row. Strided output
sites default to the decimation rule ``floor(in / stride)``, as in the JAX
package; ``rule="union"`` gives spconv's receptive-field union.

Kernels on this path: the fused rank-table rulebook build (one launch a
rulebook on a RankTable, ``rank_lookup.rulebook_rank``), its front end and
decode around the sorted-keys merge lookup (three launches a rulebook on a
KeyTable), all through ``build_rulebook``, and the fused rulebook conv
(every conv: forward, dX under the transposed rulebook and dW, through
``rulebook_conv.RulebookConvFn``).
"""

from dataclasses import dataclass

import torch

from . import coords as coord_ops
from .merge_lookup import merge_cells
from .rank_lookup import (RulebookSpec, gather_cells, rank_bits,
                          rulebook_cells, rulebook_decode, rulebook_rank)
from ..utils.spans import span
from .rulebook_conv import RulebookConvFn


def _triple(v):
    if isinstance(v, (tuple, list)):
        assert len(v) == 3
        return tuple(int(x) for x in v)
    return (int(v),) * 3


@dataclass
class SparseStructure:
    """A padded active-voxel coordinate set (prefix-valid rows)."""

    coords: torch.Tensor  # [B, V, 3] int32 (z, y, x); invalid rows = -1
    num_voxels: torch.Tensor  # [B] int32
    spatial_shape: tuple  # (Z, Y, X)

    @property
    def capacity(self):
        return self.coords.shape[1]

    @property
    def batch_size(self):
        return self.coords.shape[0]

    def valid_mask(self):
        return coord_ops.valid_rows(self.num_voxels, self.capacity)


@dataclass
class SparseTensor:
    structure: SparseStructure
    features: torch.Tensor  # [B, V, C]

    def valid_mask(self):
        return self.structure.valid_mask()


def build_structure(coords, num_voxels, spatial_shape):
    """Create a SparseStructure from padded, key-sorted coords."""
    coord_ops.check_shape_fits_int32(spatial_shape)
    return SparseStructure(
        coords=coords.to(torch.int32).contiguous(),
        num_voxels=num_voxels.to(torch.int32).contiguous(),
        spatial_shape=tuple(int(s) for s in spatial_shape),
    )


# Lookup-table kind of the rulebook builds (the JAX package's TABLE_KIND
# without its "hash" and "dense" oracle kinds):
#   "auto" - "rank" while the packed table is small, "keys" beyond that;
#   "rank" - dense packed rank table (coords.RankTable);
#   "keys" - sorted voxel keys, no dense table (coords.KeyTable).
TABLE_KIND = "auto"
# "auto" keeps the JAX package's rule so each stage takes the same table
# kind as the reference: a RankTable while its packed table, padded to
# 1024 cells, fits the 12 MiB VMEM budget of the TPU lookup kernel
# (lidarseg3d_tpu/ops/pallas_lookup.py supported, LOOKUP_VMEM_BUDGET).
RANK_TABLE_MAX_CELLS = 12 * 2**20 // 4  # 3,145,728 int32 cells


def set_table_kind(kind):
    global TABLE_KIND
    if kind not in ("auto", "rank", "keys"):
        raise ValueError(f"unknown table kind {kind!r}")
    TABLE_KIND = kind


def table_kind(spatial_shape):
    """The table kind ``dense_table`` builds for a grid: TABLE_KIND, with
    "auto" resolved by the cell count of the x-extended grid."""
    kind = TABLE_KIND
    if kind == "auto":
        Z, Y, X = (int(d) for d in spatial_shape)
        ncells = -(-(Z * Y * (X + 2)) // 1024) * 1024
        kind = "rank" if ncells <= RANK_TABLE_MAX_CELLS else "keys"
    return kind


def dense_table(s: SparseStructure):
    """Lookup table for structure ``s``, built once per structure per
    forward and shared by its rulebooks: a RankTable or a KeyTable, as
    ``table_kind`` picks (despite the name, which the JAX package keeps
    too, a KeyTable holds no dense table)."""
    kind = table_kind(s.spatial_shape)
    if kind == "rank":
        return coord_ops.build_rank_table(s.coords, s.num_voxels,
                                          s.spatial_shape)
    return coord_ops.build_key_table(s.coords, s.num_voxels, s.spatial_shape)


def flat_features(features):
    """[B, V, C] -> [B*V + 1, C] with a trailing zero row for misses."""
    B, V, C = features.shape
    return torch.cat([features.reshape(B * V, C),
                      features.new_zeros(1, C)], dim=0)


def kernel_cells(table, cell, inb):
    """The query cells the sorted devoxelization hands the lookup kernel
    of ``table``: clipped to the grid and, on a KeyTable, clamped per
    (group, sample) row to the row's largest ``inb`` cell, as the JAX
    package's _merge_cells does for its merge kernel and its XLA oracle
    alike. The devoxelization reads the own cell's rank at every position,
    so the clamp decides which fallback voxel an out-of-grid point gets. A
    rulebook reads only its ``inb`` positions, so its build needs no clamp
    (rank_lookup.rulebook_queries).

    RankTables are not clamped. That follows the JAX package on the CPU
    (its XLA gather, what the tests hold the port against); its Pallas
    lookup on a TPU clamps RankTable queries too, so there an out-of-grid
    point on the sorted devoxelization over a RankTable (no rulebook; on
    neither main path) may get another fallback voxel (ROADMAP C)."""
    Z, Y, X = (int(s) for s in table.spatial_shape)
    cell = cell.clamp(0, Z * Y * (X + 2) - 1)
    if isinstance(table, coord_ops.KeyTable):
        maxc = torch.where(inb, cell, 0).amax(dim=-1, keepdim=True)
        cell = torch.minimum(cell, maxc)
    return cell.to(torch.int32).contiguous()


def lookup_rank3_cells(table, cell, inb):
    """One lookup per query -> rows of cells x-1, x, x+1:
    ((idx_m, f_m), (idx_0, f_0), (idx_p, f_p)), each [G, B, V]. ``cell``
    [G, B, V] is on the x-extended grid, arbitrary where ``inb`` is False.
    A RankTable takes the rank_lookup kernel (no monotone clamping: the GPU
    kernel reads any cell), a KeyTable the merge_lookup kernel."""
    cells = kernel_cells(table, cell, inb)
    if isinstance(table, coord_ops.KeyTable):
        v = merge_cells(table.keys, table.coarse, table.shift, table.num,
                        cells)
    else:
        v = gather_cells(table.packed, cells)
    rank, am, a0, ap = rank_bits(v)
    i32 = torch.int32
    return (((rank - a0 - 1).to(i32), inb & (am > 0)),
            ((rank - 1).to(i32), inb & (a0 > 0)),
            ((rank + ap - 1).to(i32), inb & (ap > 0)))


def _x_taps(table, ks, pad):
    """The spec's x padding for a kernel of ``ks`` with padding ``pad``:
    a kernel 3 wide in x keeps it; one 1 wide in x is built as the 3-wide
    groups with the x padding one larger, whose middle tap queries the
    1-wide kernel's cell (RulebookSpec.kx). Tables other than rank and key
    tables, and other widths, raise."""
    if not isinstance(table, (coord_ops.RankTable, coord_ops.KeyTable)):
        raise NotImplementedError(
            f"the port builds rulebooks on rank or key tables; got "
            f"{type(table).__name__}")
    if ks[2] == 3:
        return tuple(pad)
    if ks[2] == 1:
        return (pad[0], pad[1], pad[2] + 1)
    raise NotImplementedError(f"kernel {ks}: x width {ks[2]} (1 or 3)")


def build_rulebook(table, s: SparseStructure, spec: RulebookSpec):
    """The [K, B, V] flat rulebook ``spec`` for the rows of ``s``: on a
    RankTable one fused kernel (rank_lookup.rulebook_rank); on a KeyTable
    the query cells, the merge lookup and the decode. A kernel one tap
    wide in x (spec.kx == 1) keeps each group's middle tap."""
    if isinstance(table, coord_ops.KeyTable):
        cells = rulebook_cells(s.coords, s.num_voxels, spec)
        values = merge_cells(table.keys, table.coarse, table.shift,
                             table.num, cells)
        rb = rulebook_decode(values, s.coords, s.num_voxels, spec)
    else:
        rb = rulebook_rank(table.packed, s.coords, s.num_voxels, spec)
    if spec.kx == 1:
        G, (_, B, V) = spec.groups, rb.shape
        rb = rb.view(G, 3, B, V)[:, 1].contiguous()
    return rb


def subm_spec(table, s: SparseStructure, kernel_size=3):
    """RulebookSpec of a submanifold conv on ``s``: stride 1, the kernel
    centred (padding kz // 2, ky // 2 and kx // 2)."""
    kz, ky, kx = ks = _triple(kernel_size)
    pad = _x_taps(table, ks, (kz // 2, ky // 2, kx // 2))
    return RulebookSpec(False, kz, ky, (1, 1, 1), pad, table.spatial_shape,
                        s.capacity, kx)


def build_subm_rulebook(s: SparseStructure, kernel_size=3, table=None):
    """[K, B, V] flat rulebook of a submanifold conv on ``s``; each
    (dz, dy) group of x-taps costs one table lookup."""
    if table is None:
        table = dense_table(s)
    return build_rulebook(table, s, subm_spec(table, s, kernel_size))


def delinearize(keys, spatial_shape):
    """linear keys -> coords [..., 3] (z, y, x); INVALID_KEY -> -1."""
    _, Y, X = (int(s) for s in spatial_shape)
    z = keys // (Y * X)
    rem = keys % (Y * X)
    c = torch.stack([z, rem // X, rem % X], dim=-1)
    return torch.where((keys == coord_ops.INVALID_KEY)[..., None], -1, c)


def unique_coords(coords, valid_mask, spatial_shape, capacity):
    """Deduplicate coords per sample into a fixed-capacity, key-sorted set.

    Returns (out_coords [B, capacity, 3], out_num [B], sorted_keys
    [B, capacity]); voxels beyond ``capacity`` (the largest keys) drop.
    The sort formulation of the JAX package's unique_coords (its dense
    formulation gives the same result)."""
    _, Y, X = (int(s) for s in spatial_shape)
    keys = (coords[..., 0] * Y + coords[..., 1]) * X + coords[..., 2]
    keys = torch.where(valid_mask, keys, coord_ops.INVALID_KEY).to(
        torch.int32)
    B = keys.shape[0]
    sk, _ = torch.sort(keys, dim=-1)
    prev = torch.cat([sk.new_full((B, 1), -1), sk[:, :-1]], dim=1)
    first = (sk != prev) & (sk != coord_ops.INVALID_KEY)
    ranks = torch.cumsum(first.to(torch.int32), dim=1, dtype=torch.int32)
    pos = torch.where(first & (ranks <= capacity), ranks - 1, capacity)
    out = sk.new_full((B, capacity + 1), coord_ops.INVALID_KEY)
    out.scatter_(1, pos.to(torch.int64), sk)  # dropped keys hit column cap
    ukeys = out[:, :capacity]
    num = torch.clamp(ranks[:, -1], max=capacity).to(torch.int32)
    return delinearize(ukeys, spatial_shape).to(torch.int32), num, ukeys


def downsample_structure(st_struct: SparseStructure, stride, capacity,
                         kernel_size=3, padding=1, rule="decimation"):
    """Output sites of a strided conv: ``rule="decimation"`` is
    unique(floor(coords / stride)); ``rule="union"`` is every output whose
    receptive field holds an active input (spconv parity)."""
    sz3 = _triple(stride)
    in_shape = st_struct.spatial_shape
    out_shape = tuple(-(-d // s) for d, s in zip(in_shape, sz3))
    valid = st_struct.valid_mask()
    coords = st_struct.coords

    if rule == "union":
        ks3, pd3 = _triple(kernel_size), _triple(padding)
        ncand = [-(-k // s) for k, s in zip(ks3, sz3)]
        los, his = [], []
        for d in range(3):
            i = coords[..., d]
            k, s, p = ks3[d], sz3[d], pd3[d]
            los.append(-torch.div(-(i + p - k + 1), s, rounding_mode="floor"))
            his.append(torch.div(i + p, s, rounding_mode="floor"))
        cands, cvals = [], []
        for jz in range(ncand[0]):
            for jy in range(ncand[1]):
                for jx in range(ncand[2]):
                    oz, oy, ox = los[0] + jz, los[1] + jy, los[2] + jx
                    ok = (valid & (oz <= his[0]) & (oy <= his[1])
                          & (ox <= his[2]) & (oz >= 0) & (oy >= 0)
                          & (ox >= 0) & (oz < out_shape[0])
                          & (oy < out_shape[1]) & (ox < out_shape[2]))
                    cands.append(torch.stack([oz, oy, ox], dim=-1))
                    cvals.append(ok)
        out_coords, out_num, _ = unique_coords(
            torch.cat(cands, dim=1), torch.cat(cvals, dim=1), out_shape,
            capacity)
    elif rule == "decimation":
        stride_t = torch.tensor(sz3, dtype=coords.dtype, device=coords.device)
        out_coords, out_num, _ = unique_coords(
            torch.div(coords, stride_t, rounding_mode="floor"), valid,
            out_shape, capacity)
    else:
        raise ValueError(f"unknown output-site rule {rule!r}")
    return SparseStructure(coords=out_coords, num_voxels=out_num,
                           spatial_shape=out_shape)


def strided_spec(table, s_in: SparseStructure, kernel_size=3, stride=2,
                 padding=1):
    """RulebookSpec of a strided conv reading ``s_in``: input coord =
    o*stride + k - pad. The x-taps query consecutive cells, so one lookup
    at the middle cell serves all three."""
    ks, sz, pad = _triple(kernel_size), _triple(stride), _triple(padding)
    pad = _x_taps(table, ks, pad)
    if pad[2] > 2:
        raise NotImplementedError(f"x padding {pad[2]} > 2")
    return RulebookSpec(False, ks[0], ks[1], sz, pad, table.spatial_shape,
                        s_in.capacity, ks[2])


def build_strided_rulebook(s_in: SparseStructure, out_struct: SparseStructure,
                           kernel_size=3, stride=2, padding=1, table=None):
    """Rulebook of a strided conv from ``s_in`` onto ``out_struct``."""
    if table is None:
        table = dense_table(s_in)
    return build_rulebook(table, out_struct, strided_spec(
        table, s_in, kernel_size, stride, padding))


def inverse_spec(table, s_low: SparseStructure, kernel_size=3, stride=2,
                 padding=1):
    """RulebookSpec of the inverse conv reading ``s_low``: source d =
    (t + pad - k) / stride, valid iff the division is exact (the exact
    transpose of the strided rulebook). With sx=2 the two same-parity x
    numerators of a group map to consecutive source cells, so one lookup
    still serves the group."""
    ks, sz, pad = _triple(kernel_size), _triple(stride), _triple(padding)
    pad = _x_taps(table, ks, pad)
    if sz[2] not in (1, 2):
        raise NotImplementedError(f"x stride {sz[2]}")
    return RulebookSpec(True, ks[0], ks[1], sz, pad, table.spatial_shape,
                        s_low.capacity, ks[2])


def build_inverse_rulebook(s_low: SparseStructure,
                           target_struct: SparseStructure, kernel_size=3,
                           stride=2, padding=1, table=None):
    """Rulebook of the inverse conv from ``s_low`` back onto
    ``target_struct``."""
    if table is None:
        table = dense_table(s_low)
    return build_rulebook(table, target_struct, inverse_spec(
        table, s_low, kernel_size, stride, padding))


def _conv(features, weights, rulebook, rulebook_t=None):
    with span("sparse_conv"):
        return RulebookConvFn.apply(
            flat_features(features), weights, rulebook.contiguous(),
            None if rulebook_t is None else rulebook_t.contiguous())


def subm_conv(st: SparseTensor, weights, rulebook):
    """Submanifold sparse conv: output sites == input sites.
    weights [K, Cin, Cout]; rulebook [K, B, V] -> features [B, V, Cout].
    Its transposed rulebook (backward) is its own, taps mirrored."""
    return _conv(st.features, weights, rulebook)


def strided_conv(st: SparseTensor, weights, rulebook, rulebook_t=None):
    """Strided sparse conv onto a precomputed output structure.
    ``rulebook_t`` is the paired inverse rulebook, needed only when a
    gradient flows back through the conv."""
    return _conv(st.features, weights, rulebook, _paired(rulebook_t, st,
                                                         weights))


def inverse_conv(st_low: SparseTensor, weights, rulebook, rulebook_t=None):
    """Inverse sparse conv back onto a stored high-resolution structure.
    ``rulebook_t`` is the paired strided rulebook, needed only when a
    gradient flows back through the conv."""
    return _conv(st_low.features, weights, rulebook,
                 _paired(rulebook_t, st_low, weights))


def _paired(rulebook_t, st, weights):
    if rulebook_t is None and torch.is_grad_enabled() and (
            st.features.requires_grad or weights.requires_grad):
        raise ValueError("a strided or inverse conv under autograd needs "
                         "its paired rulebook (rulebook_t)")
    return rulebook_t


def voxel_centers(st_struct: SparseStructure, voxel_size, point_cloud_range):
    """Metric xyz centers of the voxels (invalid rows are garbage)."""
    dev = st_struct.coords.device
    vs = torch.tensor(voxel_size, dtype=torch.float32, device=dev)
    org = torch.tensor(point_cloud_range[:3], dtype=torch.float32, device=dev)
    xyz_idx = st_struct.coords.to(torch.float32).flip(-1)
    return (xyz_idx + 0.5) * vs + org
