"""Voxel-coordinate rank tables (PyTorch port of the RankTable part of
lidarseg3d_tpu/ops/coords.py).

Layout convention: per-sample capacity padding, coords [B, V, 3] int32 in
(z, y, x) order, invalid rows -1, valid rows a key-sorted prefix of length
num_voxels[b].
"""

from dataclasses import dataclass

import torch

from .rank_lookup import gather_cells
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


def extended_cells(coords, spatial_shape):
    """(z, y, x) -> flat cell on the x-extended grid, (z*Y + y)*(X+2) + x+1."""
    _, Y, X = (int(s) for s in spatial_shape)
    return ((coords[..., 0] * Y + coords[..., 1]) * (X + 2)
            + coords[..., 2] + 1)


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
    the rank_pack kernel on CUDA tensors for every table size."""
    act = activity(coords, num_voxels, spatial_shape)
    nce = act.shape[1] - 1
    packed = torch.stack([pack_rank_table(a[:nce]) for a in act])
    return RankTable(packed=packed,
                     spatial_shape=tuple(int(s) for s in spatial_shape))


def rank_bits(v):
    """packed value -> (rank, act(c-1), act(c), act(c+1))."""
    return v >> 3, (v >> 2) & 1, (v >> 1) & 1, v & 1


def lookup_rank(table: RankTable, qcoords, extra_valid=None):
    """Single-cell lookup: qcoords [B, Q, 3] (z, y, x) -> (row [B, Q] int32,
    found [B, Q] bool). The gather is the rank_lookup kernel's, one group."""
    Z, Y, X = (int(s) for s in table.spatial_shape)
    nce = Z * Y * (X + 2)
    bounds = torch.tensor([Z, Y, X], dtype=qcoords.dtype,
                          device=qcoords.device)
    inb = torch.all((qcoords >= 0) & (qcoords < bounds), dim=-1)
    if extra_valid is not None:
        inb = inb & extra_valid
    cell = extended_cells(qcoords, table.spatial_shape).clamp(0, nce - 1)
    v = gather_cells(table.packed, cell.to(torch.int32)[None].contiguous())[0]
    rank, _, a0, _ = rank_bits(v)
    return (rank - 1).to(torch.int32), inb & (a0 > 0)
