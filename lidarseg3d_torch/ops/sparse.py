"""Sparse 3D convolution as gather -> GEMM over key-sorted voxel sets
(PyTorch port of lidarseg3d_tpu/ops/sparse.py, rank-table path).

For every kernel offset each output voxel has AT MOST ONE input partner,
so a sparse conv is K gathers + K matmuls with no scatter:

    out[b, j] = sum_k  W[k] @ features[b, lookup(out_coord[b, j] -> tap k)]

Rulebooks are [K, B, V] global flat rows into the ``flat_features`` table
[B*V_in + 1, C]; a miss is B*V_in, the trailing zero row. Strided output
sites default to the decimation rule ``floor(in / stride)``, as in the JAX
package; ``rule="union"`` gives spconv's receptive-field union.

Kernels on this path: the rank-table lookup (every rulebook build, through
``lookup_rank3_cells``) and the fused rulebook conv (every conv).
"""

from dataclasses import dataclass

import torch

from . import coords as coord_ops
from .rank_lookup import gather_cells
from .rulebook_conv import rulebook_conv


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
        coords=coords.to(torch.int32),
        num_voxels=num_voxels.to(torch.int32),
        spatial_shape=tuple(int(s) for s in spatial_shape),
    )


def dense_table(s: SparseStructure, kind="auto"):
    """Lookup table for structure ``s``, built once per structure per
    forward and shared by its rulebooks. The port serves the rank table
    ("auto" -> "rank"): a GPU thread reads the table from device memory at
    any size, so the JAX package's VMEM-budget dispatch to "keys" does not
    apply here."""
    if kind in ("auto", "rank"):
        return coord_ops.build_rank_table(s.coords, s.num_voxels,
                                          s.spatial_shape)
    if kind == "keys":
        raise NotImplementedError(
            "the sorted-keys table (KeyTable, merge kernel) is not ported "
            "yet (ROADMAP.md B2)")
    raise ValueError(f"unknown table kind {kind!r}")


def flatten_indices(idx, found, v_in):
    """Per-sample rows [..., B, Q] -> global flat rows into [B*v_in + 1, C];
    misses map to the shared zero row B*v_in."""
    B = idx.shape[-2]
    offs = (torch.arange(B, dtype=torch.int32, device=idx.device)
            * v_in)[:, None]
    return torch.where(found, idx + offs, B * v_in).to(torch.int32)


def flat_features(features):
    """[B, V, C] -> [B*V + 1, C] with a trailing zero row for misses."""
    B, V, C = features.shape
    return torch.cat([features.reshape(B * V, C),
                      features.new_zeros(1, C)], dim=0)


def rank3_query_cells(table, qc, gvalid):
    """Grouped 3-x-tap queries: qc [G, B, V, 3] (z, y, x) with x in the
    extended range [-1, X] -> (cell [G, B, V] int32 clipped to the table,
    inb [G, B, V] validity)."""
    Z, Y, X = (int(s) for s in table.spatial_shape)
    z, y, x = qc[..., 0], qc[..., 1], qc[..., 2]
    inb = ((z >= 0) & (z < Z) & (y >= 0) & (y < Y)
           & (x >= -1) & (x <= X) & gvalid)
    nce = Z * Y * (X + 2)
    cell = coord_ops.extended_cells(qc, table.spatial_shape).clamp(0, nce - 1)
    return cell.to(torch.int32), inb


def lookup_rank3_cells(table, cell, inb):
    """One gather per query -> rows of cells x-1, x, x+1:
    ((idx_m, f_m), (idx_0, f_0), (idx_p, f_p)), each [G, B, V]. Only the
    ``inb`` positions are consumed; the GPU kernel needs no monotone
    clamping of the others (the TPU kernel did)."""
    v = gather_cells(table.packed, cell.contiguous())
    rank, am, a0, ap = coord_ops.rank_bits(v)
    i32 = torch.int32
    return (((rank - a0 - 1).to(i32), inb & (am > 0)),
            ((rank - 1).to(i32), inb & (a0 > 0)),
            ((rank + ap - 1).to(i32), inb & (ap > 0)))


def _lookup_rank3_groups(table, qc, gvalid):
    return lookup_rank3_cells(table, *rank3_query_cells(table, qc, gvalid))


def _stack_taps(lookups, v_in, G):
    """Three (idx, found) [G, B, V] lookups -> [G*3, B, V] flat rulebook
    in raster tap order (dx innermost)."""
    out = torch.stack([flatten_indices(i, f, v_in) for i, f in lookups],
                      dim=1)
    return out.reshape(G * 3, *out.shape[2:])


def _require_rank3(table, ks):
    if not isinstance(table, coord_ops.RankTable) or ks[2] != 3:
        raise NotImplementedError(
            "the port builds rulebooks on rank tables for kernels 3 wide "
            f"in x; got {type(table).__name__}, kernel {ks}")


def subm_queries(s: SparseStructure, kernel_size=3):
    """Grouped queries of a submanifold rulebook: (qc [G, B, V, 3] centre
    cells of the (dz, dy) groups, gvalid [G, B, V])."""
    kz, ky, _ = _triple(kernel_size)
    d = torch.tensor([(dz - kz // 2, dy - ky // 2, 0)
                      for dz in range(kz) for dy in range(ky)],
                     dtype=torch.int32, device=s.coords.device)
    qc = s.coords[None] + d[:, None, None, :]
    return qc, s.valid_mask()[None].expand(qc.shape[:-1])


def build_subm_rulebook(s: SparseStructure, kernel_size=3, table=None):
    """[K, B, V] flat rulebook of a submanifold conv on ``s``; each
    (dz, dy) group of three x-taps costs one rank-table gather."""
    ks = _triple(kernel_size)
    if table is None:
        table = dense_table(s)
    _require_rank3(table, ks)
    return _stack_taps(_lookup_rank3_groups(table, *subm_queries(s, ks)),
                       s.capacity, ks[0] * ks[1])


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


def build_strided_rulebook(s_in: SparseStructure, out_struct: SparseStructure,
                           kernel_size=3, stride=2, padding=1, table=None):
    """Rulebook of a strided conv: input coord = o*stride + k - pad. The
    x-taps query consecutive cells, so one gather at the middle cell serves
    all three."""
    ks, sz, pad = _triple(kernel_size), _triple(stride), _triple(padding)
    if table is None:
        table = dense_table(s_in)
    _require_rank3(table, ks)
    if pad[2] > 2:
        raise NotImplementedError(f"x padding {pad[2]} > 2")
    dev = out_struct.coords.device
    base = out_struct.coords * torch.tensor(sz, dtype=torch.int32,
                                            device=dev)
    kz, ky, _ = ks
    d = [(dz - pad[0], dy - pad[1]) for dz in range(kz) for dy in range(ky)]
    dza = torch.tensor([a for a, _ in d], dtype=torch.int32,
                       device=dev)[:, None, None]
    dya = torch.tensor([b for _, b in d], dtype=torch.int32,
                       device=dev)[:, None, None]
    qc = torch.stack([
        base[None, ..., 0] + dza,
        base[None, ..., 1] + dya,
        base[None, ..., 2] + torch.zeros_like(dza) + (1 - pad[2]),
    ], dim=-1)  # [G, B, V, 3]
    gvalid = out_struct.valid_mask()[None].expand(qc.shape[:-1])
    return _stack_taps(_lookup_rank3_groups(table, qc, gvalid),
                       s_in.capacity, kz * ky)


def build_inverse_rulebook(s_low: SparseStructure,
                           target_struct: SparseStructure, kernel_size=3,
                           stride=2, padding=1, table=None):
    """Rulebook of the inverse conv: source d = (t + pad - k) / stride,
    valid iff the division is exact (the exact transpose of the strided
    rulebook). With sx=2 the two same-parity x numerators of a group map to
    consecutive source cells, so one gather still serves the group."""
    ks, sz, pad = _triple(kernel_size), _triple(stride), _triple(padding)
    if table is None:
        table = dense_table(s_low)
    _require_rank3(table, ks)
    if sz[2] not in (1, 2):
        raise NotImplementedError(f"x stride {sz[2]}")
    tc = target_struct.coords
    dev = tc.device
    kz, ky, _ = ks
    sxi = sz[2]
    miss = target_struct.batch_size * s_low.capacity
    d = [(dz, dy) for dz in range(kz) for dy in range(ky)]
    dza = torch.tensor([a for a, _ in d], dtype=torch.int32,
                       device=dev)[:, None, None]
    dya = torch.tensor([b for _, b in d], dtype=torch.int32,
                       device=dev)[:, None, None]
    num_z = tc[None, ..., 0] + pad[0] - dza
    num_y = tc[None, ..., 1] + pad[1] - dya
    ez = num_z % sz[0] == 0
    ey = num_y % sz[1] == 0
    zq = torch.div(num_z, sz[0], rounding_mode="floor")
    yq = torch.div(num_y, sz[1], rounding_mode="floor")
    n0 = tc[None, ..., 2] + pad[2]  # [1, B, V]
    gvalid = target_struct.valid_mask()[None] & ez & ey
    center = (n0 - 1) if sxi == 1 else ((n0 - 1) >> 1)
    qc = torch.stack([zq, yq, center.expand(zq.shape)], dim=-1)
    (im, fm), (i0, f0), (ip, fp) = _lookup_rank3_groups(table, qc, gvalid)
    v_lo = s_low.capacity
    gm, g0, gp = (flatten_indices(i, f, v_lo)
                  for i, f in ((im, fm), (i0, f0), (ip, fp)))
    if sxi == 1:
        # dx=0 -> cell n0 (=center+1), dx=1 -> n0-1, dx=2 -> n0-2
        out = torch.stack([gp, g0, gm], dim=1)
    else:
        even = ((n0 & 1) == 0).expand(gp.shape)
        # even n0: dx=0 at cell n0/2 (=g+1), dx=2 at n0/2-1 (=g);
        # odd n0: dx=1 at (n0-1)/2 (=g)
        out = torch.stack([torch.where(even, gp, miss),
                           torch.where(even, miss, g0),
                           torch.where(even, g0, miss)], dim=1)
    return out.reshape(kz * ky * 3, *out.shape[2:]).to(torch.int32)


def _conv(features, weights, rulebook):
    return rulebook_conv(flat_features(features), rulebook.contiguous(),
                         weights)


def subm_conv(st: SparseTensor, weights, rulebook):
    """Submanifold sparse conv: output sites == input sites.
    weights [K, Cin, Cout]; rulebook [K, B, V] -> features [B, V, Cout]."""
    return _conv(st.features, weights, rulebook)


def strided_conv(st: SparseTensor, weights, rulebook):
    """Strided sparse conv onto a precomputed output structure."""
    return _conv(st.features, weights, rulebook)


def inverse_conv(st_low: SparseTensor, weights, rulebook):
    """Inverse sparse conv back onto a stored high-resolution structure."""
    return _conv(st_low.features, weights, rulebook)


def voxel_centers(st_struct: SparseStructure, voxel_size, point_cloud_range):
    """Metric xyz centers of the voxels (invalid rows are garbage)."""
    dev = st_struct.coords.device
    vs = torch.tensor(voxel_size, dtype=torch.float32, device=dev)
    org = torch.tensor(point_cloud_range[:3], dtype=torch.float32, device=dev)
    xyz_idx = st_struct.coords.to(torch.float32).flip(-1)
    return (xyz_idx + 0.5) * vs + org
