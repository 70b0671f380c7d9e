"""Voxel-coordinate lookup tables (PyTorch port of the RankTable and
KeyTable parts of lidarseg3d_tpu/ops/coords.py).

Layout convention: per-sample capacity padding, coords [B, V, 3] int32 in
(z, y, x) order, invalid rows -1, valid rows a key-sorted prefix of length
num_voxels[b].
"""

from dataclasses import dataclass

import torch

from .merge_lookup import merge_cells
from .rank_lookup import extended_cells, lookup_single, rank_bits
from .rank_pack import pack_rank_table

INVALID_KEY = 2**31 - 1  # sorts to the end; never a valid key


def check_shape_fits_int32(spatial_shape):
    total = 1
    for s in spatial_shape:
        total *= int(s)
    if total >= 2**31 - 1:
        raise ValueError(
            f"spatial_shape {spatial_shape} has {total} cells; linear int32 "
            "keys would overflow. Use a coarser grid or tighter range.")


def valid_rows(num_voxels, V):
    """[B, V] bool: row index < num_voxels[b]."""
    return (torch.arange(V, device=num_voxels.device)[None, :]
            < num_voxels[:, None])


@dataclass
class RankTable:
    """Direct-address table of PACKED cumulative ranks + activity bits.

    cell value = (rank << 3) | act(cell-1) << 2 | act(cell) << 1 | act(cell+1)
    where rank = number of active cells <= cell (per sample) and ``cell``
    indexes an X-EXTENDED grid (x in [-1, X], row width X+2), so the
    neighbour bits never alias another y-row. With key-sorted voxel rows,
    rank-1 is the row of an active cell, and one gather yields the rows of
    the three x-taps of a 3^3 kernel group.
    """

    packed: torch.Tensor  # [B, Z*Y*(X+2)] int32
    spatial_shape: tuple  # original (Z, Y, X)


def activity(coords, num_voxels, spatial_shape):
    """[B, NCE + 1] int8 activity bitmap on the x-extended grid; invalid
    rows land on the scratch cell NCE. Plain PyTorch (it is XLA outside the
    Pallas kernel in the JAX package)."""
    B, V, _ = coords.shape
    Z, Y, X = (int(s) for s in spatial_shape)
    nce = Z * Y * (X + 2)
    cell = torch.where(valid_rows(num_voxels, V),
                       extended_cells(coords, spatial_shape), nce)
    act = torch.zeros(B, nce + 1, dtype=torch.int8, device=coords.device)
    return act.scatter_(1, cell.to(torch.int64), 1)


def build_rank_table(coords, num_voxels, spatial_shape):
    """Build the packed rank/activity table (see RankTable); the pack runs
    the rank_pack kernel on CUDA tensors for every table size, one launch
    for all samples, reading the activity bitmap in place (its scratch
    cell NCE is left out)."""
    act = activity(coords, num_voxels, spatial_shape)
    packed = pack_rank_table(act, act.shape[1] - 1)
    return RankTable(packed=packed,
                     spatial_shape=tuple(int(s) for s in spatial_shape))


def lookup_rank(table: RankTable, qcoords, extra_valid=None):
    """Single-cell lookup: qcoords [B, Q, 3] (z, y, x) -> (row [B, Q] int32,
    found [B, Q] bool); one launch of rank_lookup.lookup_single on CUDA
    tensors."""
    return lookup_single(table.packed, table.spatial_shape,
                         qcoords.to(torch.int32).contiguous(),
                         None if extra_valid is None
                         else extra_valid.contiguous())


@dataclass
class KeyTable:
    """Sorted-keys lookup table: no dense per-cell storage.

    keys are the voxels' cells on the X-EXTENDED grid (the RankTable's cell
    space), ascending, with INVALID_KEY after ``num``; key-sorted voxel rows
    make rank-1 the row of an active cell, as for a RankTable. The merge
    lookup (ops/merge_lookup.py) answers a grouped query with the same
    packed (rank, am, a0, ap) value a RankTable gather gives. The block
    ranks ``coarse[b, j]`` = #{valid keys < j << shift} bracket each of
    its searches. Unlike the JAX package, V is not padded to a multiple of
    1024 (that was the TPU kernel's VMEM layout).
    """

    keys: torch.Tensor  # [B, V] int32
    coarse: torch.Tensor  # [B, NB + 1] int32
    num: torch.Tensor  # [B] int32
    spatial_shape: tuple  # original (Z, Y, X)
    shift: int = 12


def build_key_table(coords, num_voxels, spatial_shape, shift=12):
    """Build a KeyTable (see above); O(V + NCE >> shift)."""
    B, V, _ = coords.shape
    Z, Y, X = (int(s) for s in spatial_shape)
    nce = Z * Y * (X + 2)
    valid = valid_rows(num_voxels, V)
    cell = extended_cells(coords, spatial_shape)
    keys = torch.where(valid, cell, INVALID_KEY).to(torch.int32)
    nb = (nce >> shift) + 2
    blk = torch.where(valid, cell >> shift, nb).to(torch.int64)
    hist = torch.zeros(B, nb + 1, dtype=torch.int32, device=coords.device)
    hist.scatter_add_(1, blk, torch.ones_like(blk, dtype=torch.int32))
    coarse = torch.cat([hist.new_zeros(B, 1),
                        torch.cumsum(hist[:, :nb], 1, dtype=torch.int32)], 1)
    return KeyTable(keys=keys, coarse=coarse,
                    num=num_voxels.to(torch.int32),
                    spatial_shape=(Z, Y, X), shift=shift)



# the JAX package pads a KeyTable's keys to a multiple of its merge
# kernel's 1024-key window (lidarseg3d_tpu/ops/pallas_merge.py WIN);
# lookup_key clips a miss's position to that padded length, as it does
JAX_KEY_PAD = 1024


def lookup_key(table: KeyTable, qcoords, extra_valid=None):
    """Single-cell lookup on a KeyTable, the contract of lookup_rank:
    qcoords [B, Q, 3] (z, y, x), extra_valid [B, Q] bool or None -> (row
    [B, Q] int32, found [B, Q] bool), equal to the JAX package's
    searchsorted lookup at every position: a found cell's row is its key
    position; elsewhere the row is the count of keys below the cell,
    clipped to the JAX package's padded key count. The answer comes from
    the merge kernel (one launch on CUDA tensors): rank - act(cell) keys
    lie below a cell. A cell is clamped into the x-extended grid first;
    the grid's first and last cells are never keys, so a clamped query
    counts the keys an unclamped one would."""
    Z, Y, X = (int(s) for s in table.spatial_shape)
    nce = Z * Y * (X + 2)
    bounds = torch.tensor([Z, Y, X], dtype=qcoords.dtype,
                          device=qcoords.device)
    inb = torch.all((qcoords >= 0) & (qcoords < bounds), dim=-1)
    if extra_valid is not None:
        inb = inb & extra_valid
    cell = extended_cells(qcoords.to(torch.int32), table.spatial_shape)
    cell = cell.clamp(0, nce - 1).to(torch.int32).contiguous()
    v = merge_cells(table.keys, table.coarse, table.shift, table.num,
                    cell[None])[0]
    rank, _, a0, _ = rank_bits(v)
    V = table.keys.shape[1]
    vp = -(-V // JAX_KEY_PAD) * JAX_KEY_PAD
    return (rank - a0).clamp(max=vp - 1).to(torch.int32), inb & (a0 > 0)


def lookup_coords(table, qcoords, spatial_shape, extra_valid=None):
    """Coordinate-level lookup dispatching on the table kind (the JAX
    package's lookup_coords without its hash and dense oracle kinds)."""
    if isinstance(table, KeyTable):
        return lookup_key(table, qcoords, extra_valid)
    if isinstance(table, RankTable):
        return lookup_rank(table, qcoords, extra_valid)
    raise TypeError(f"unknown table {type(table).__name__}")
