"""Rank-table lookups: whole rulebooks, their front end and decode around
the merge kernel, the single-cell lookup, and the grouped gather.

Counterpart of lidarseg3d_tpu/ops/pallas_lookup.py::lookup_gather (and of
its HBM-resident variant ``_lookup_gather_hbm``) together with the XLA glue
of lidarseg3d_tpu/ops/sparse.py around them (``_gather_cells``, the query
stacks of ``build_subm_rulebook`` / ``build_strided_rulebook`` /
``build_inverse_rulebook`` and ``_lookup_rank3_groups``) and
lidarseg3d_tpu/ops/coords.py::lookup_rank. The kernels are in
``csrc/rank_lookup.cu``; each wrapper counts its launches in
``.launches`` and takes its ``*_plain`` twin for CPU tensors only.

- ``rulebook_rank``: a whole [K, B, V] rulebook on a RankTable, one launch.
- ``rulebook_cells`` / ``rulebook_decode``: the same rulebook on a
  KeyTable, as query cells for ``merge_lookup.merge_cells`` and the decode
  of its packed values: three launches with the merge.
- ``lookup_single``: the own-cell lookup (row, found) of points.
- ``gather_cells``: packed values at given cells (the sorted
  devoxelization on a RankTable).

A packed value is (rank << 3) | act(c-1) << 2 | act(c) << 1 | act(c+1) on
the x-extended grid (x in [-1, X], rows X + 2 wide), rank = #active cells
<= c in its sample.
"""

import ctypes
from dataclasses import dataclass

import torch

from . import cuda_build

_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIG = {"rank_lookup": [_P, _L, _P, _P, _L, _L, _L, _P],
        "rulebook_lookup": [_I, _P, _L, _P, _P, _P, _L, _L, _L] + [_I] * 11
        + [_L, _P],
        "rank_lookup_single": [_P, _L, _P, _P, _P, _P, _L, _L, _I, _I, _I,
                               _P]}
FUSED, CELLS, DECODE = 0, 1, 2  # phases of rulebook_lookup
_fns = {}


def _fn(name):
    """The ctypes function ``name`` of the library, argument types set
    (cached: a call costs the host one dictionary lookup)."""
    f = _fns.get(name)
    if f is None:
        f = _fns[name] = getattr(cuda_build.load("rank_lookup", _SIG), name)
    return f


@dataclass(frozen=True)
class RulebookSpec:
    """A rulebook's geometry: G = kz * ky groups g = dz * ky + dy of three
    x-taps (K = 3G). ``inverse`` False: a query is o * stride + k - pad
    (a subm rulebook is stride 1, padding (kz // 2, ky // 2, 1)); True: the
    inverse of a strided conv. ``grid`` (Z, Y, X) and ``v_in`` (capacity;
    a miss is B * v_in) are those of the structure whose rows it names.
    ``kx`` 1 marks a kernel one tap wide in x: the kernels still build the
    three taps of each group, with an x padding one larger than the
    conv's, and ``sparse.build_rulebook`` keeps the middle one (K = G)."""

    inverse: bool
    kz: int
    ky: int
    stride: tuple
    pad: tuple
    grid: tuple
    v_in: int
    kx: int = 3

    @property
    def groups(self):
        return self.kz * self.ky

    @property
    def nce(self):
        Z, Y, X = self.grid
        return Z * Y * (X + 2)


def extended_cells(coords, spatial_shape):
    """(z, y, x) -> flat cell on the x-extended grid, (z*Y + y)*(X+2) + x+1."""
    _, Y, X = (int(s) for s in spatial_shape)
    return ((coords[..., 0] * Y + coords[..., 1]) * (X + 2)
            + coords[..., 2] + 1)


def rank_bits(v):
    """packed value -> (rank, act(c-1), act(c), act(c+1))."""
    return v >> 3, (v >> 2) & 1, (v >> 1) & 1, v & 1


def rulebook_queries(coords, num, spec):
    """The queries of a rulebook: coords [B, V, 3] and num [B] of the
    structure whose rows it fills -> (cell [G, B, V] int32 with each query
    coordinate clamped into the x-extended grid, inb [G, B, V] bool, even
    [1, B, V] bool (inverse, sx = 2) or None). Only ``inb`` queries feed
    the rulebook, so the clamp changes nothing it holds."""
    dev = coords.device
    V = coords.shape[1]
    pz, py, px = spec.pad
    sz, sy, sx = spec.stride
    d = [(dz, dy) for dz in range(spec.kz) for dy in range(spec.ky)]
    valid = torch.arange(V, device=dev)[None, :] < num[:, None]
    even = None
    if not spec.inverse:
        base = coords * torch.tensor(spec.stride, dtype=torch.int32,
                                     device=dev)
        dza = torch.tensor([a - pz for a, _ in d], dtype=torch.int32,
                           device=dev)[:, None, None]
        dya = torch.tensor([b - py for _, b in d], dtype=torch.int32,
                           device=dev)[:, None, None]
        z = base[None, ..., 0] + dza
        y = base[None, ..., 1] + dya
        x = (base[None, ..., 2] + torch.zeros_like(dza) + (1 - px))
        gvalid = valid[None].expand(z.shape)
    else:
        dza = torch.tensor([a for a, _ in d], dtype=torch.int32,
                           device=dev)[:, None, None]
        dya = torch.tensor([b for _, b in d], dtype=torch.int32,
                           device=dev)[:, None, None]
        num_z = coords[None, ..., 0] + pz - dza
        num_y = coords[None, ..., 1] + py - dya
        z = torch.div(num_z, sz, rounding_mode="floor")
        y = torch.div(num_y, sy, rounding_mode="floor")
        n0 = coords[None, ..., 2] + px  # [1, B, V]
        x = ((n0 - 1) if sx == 1 else ((n0 - 1) >> 1)).expand(z.shape)
        gvalid = valid[None] & (num_z % sz == 0) & (num_y % sy == 0)
        if sx == 2:
            even = (n0 & 1) == 0
    Z, Y, X = spec.grid
    inb = ((z >= 0) & (z < Z) & (y >= 0) & (y < Y) & (x >= -1) & (x <= X)
           & gvalid)
    cell = extended_cells(torch.stack([z.clamp(0, Z - 1), y.clamp(0, Y - 1),
                                       x.clamp(-1, X)], dim=-1), spec.grid)
    return cell.to(torch.int32), inb, even


def _decode(values, inb, even, spec):
    """Packed values [G, B, V] of the queries -> the [K, B, V] flat
    rulebook in raster tap order (dx innermost)."""
    G, B, V = values.shape
    miss = B * spec.v_in
    offs = (torch.arange(B, dtype=torch.int32, device=values.device)
            * spec.v_in)[:, None]
    rank, am, a0, ap = rank_bits(values)

    def flat(idx, found):
        return torch.where(found, idx + offs, miss)

    gm = flat(rank - a0 - 1, inb & (am > 0))
    g0 = flat(rank - 1, inb & (a0 > 0))
    gp = flat(rank + ap - 1, inb & (ap > 0))
    if not spec.inverse:
        taps = [gm, g0, gp]
    elif spec.stride[2] == 1:
        # dx=0 -> cell n0 (=center+1), dx=1 -> n0-1, dx=2 -> n0-2
        taps = [gp, g0, gm]
    else:
        even = even.expand(gp.shape)
        # even n0: dx=0 at cell n0/2 (=g+1), dx=2 at n0/2-1 (=g);
        # odd n0: dx=1 at (n0-1)/2 (=g)
        taps = [torch.where(even, gp, miss), torch.where(even, miss, g0),
                torch.where(even, g0, miss)]
    return torch.stack(taps, dim=1).reshape(3 * G, B, V)


def rulebook_rank_plain(packed, coords, num, spec):
    """[K, B, V] int32 rulebook of ``spec`` on the RankTable ``packed``
    [B, NCE], for the structure (coords [B, V, 3], num [B]) whose rows it
    fills."""
    cell, inb, even = rulebook_queries(coords, num, spec)
    return _decode(gather_cells_plain(packed, cell), inb, even, spec)


def rulebook_cells_plain(coords, num, spec):
    """The query cells [G, B, V] int32 of ``spec`` (``rulebook_queries``'
    cell): the merge kernel's input for a rulebook on a KeyTable."""
    return rulebook_queries(coords, num, spec)[0]


def rulebook_decode_plain(values, coords, num, spec):
    """The [K, B, V] rulebook of ``spec`` from the packed values [G, B, V]
    of its query cells (``merge_cells``' answer on a KeyTable)."""
    _, inb, even = rulebook_queries(coords, num, spec)
    return _decode(values, inb, even, spec)


def lookup_single_plain(packed, grid, qcoords, extra_valid=None):
    """Single-cell lookup on the RankTable ``packed`` [B, NCE] of grid
    (Z, Y, X): qcoords [B, Q, 3] int32 (z, y, x), extra_valid [B, Q] bool
    or None -> (row [B, Q] int32 = rank - 1 of the clipped cell, at every
    position, found [B, Q] bool)."""
    Z, Y, X = grid
    nce = Z * Y * (X + 2)
    bounds = torch.tensor([Z, Y, X], dtype=qcoords.dtype,
                          device=qcoords.device)
    inb = torch.all((qcoords >= 0) & (qcoords < bounds), dim=-1)
    if extra_valid is not None:
        inb = inb & extra_valid
    cell = extended_cells(qcoords, grid).clamp(0, nce - 1)
    v = gather_cells_plain(packed, cell.to(torch.int32)[None])[0]
    rank, _, a0, _ = rank_bits(v)
    return (rank - 1).to(torch.int32), inb & (a0 > 0)


def gather_cells_plain(packed, cell):
    """packed [B, NCE] int32, cell [G, B, V] int32 in [0, NCE) ->
    [G, B, V] int32 equal to packed[b, cell[g, b, v]]."""
    B, nce = packed.shape
    offs = (torch.arange(B, device=cell.device, dtype=torch.int64)
            * nce).view(1, B, 1)
    return packed.reshape(-1)[cell.to(torch.int64) + offs]


def _check(what, tensors, shapes):
    """Every tensor of the given (shape, dtype), contiguous, on one device,
    which is the CPU or a CUDA device; returns whether that is a CUDA
    device."""
    dev = tensors[0].device
    for t, (shape, dtype) in zip(tensors, shapes):
        if (t.shape != shape or t.dtype != dtype or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(
                f"{what}: need contiguous tensors on one device of "
                f"{[(str(d), s) for s, d in shapes]}; got "
                f"{[(str(t.dtype), tuple(t.shape), str(t.device)) for t in tensors]}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")
    return dev.type == "cuda"


def _structure_shapes(coords, num):
    B, V = (coords.shape[:2] if coords.dim() == 3 and coords.shape[2] == 3
            else (-1, -1))
    return B, V, [((B, V, 3), torch.int32), ((B,), torch.int32)]


def _launch_rulebook(phase, src, nce, coords, num, out, spec):
    G, B, V = spec.groups, coords.shape[0], coords.shape[1]
    Z, Y, X = spec.grid
    err = _fn("rulebook_lookup")(
        phase, src, nce, coords.data_ptr(), num.data_ptr(), out.data_ptr(),
        G, B, V, int(spec.inverse), spec.ky, *spec.stride, *spec.pad, Z, Y,
        X, spec.v_in, cuda_build.stream_of(out))
    cuda_build.check(err, "rulebook_lookup")


def rulebook_rank(packed, coords, num, spec):
    """Same contract as ``rulebook_rank_plain``: one launch of the fused
    rulebook kernel on CUDA tensors."""
    B, V, shapes = _structure_shapes(coords, num)
    if not _check("rulebook_rank", [coords, num, packed],
                  shapes + [((B, spec.nce), torch.int32)]):
        return rulebook_rank_plain(packed, coords, num, spec)
    out = torch.empty(3 * spec.groups, B, V, dtype=torch.int32,
                      device=coords.device)
    if out.numel():
        _launch_rulebook(FUSED, packed.data_ptr(), spec.nce, coords, num,
                         out, spec)
        rulebook_rank.launches += 1
    return out


def rulebook_cells(coords, num, spec):
    """Same contract as ``rulebook_cells_plain``: the front-end kernel on
    CUDA tensors."""
    B, V, shapes = _structure_shapes(coords, num)
    if not _check("rulebook_cells", [coords, num], shapes):
        return rulebook_cells_plain(coords, num, spec)
    out = torch.empty(spec.groups, B, V, dtype=torch.int32,
                      device=coords.device)
    if out.numel():
        _launch_rulebook(CELLS, None, 0, coords, num, out, spec)
        rulebook_cells.launches += 1
    return out


def rulebook_decode(values, coords, num, spec):
    """Same contract as ``rulebook_decode_plain``: the decode kernel on
    CUDA tensors."""
    B, V, shapes = _structure_shapes(coords, num)
    if not _check("rulebook_decode", [coords, num, values],
                  shapes + [((spec.groups, B, V), torch.int32)]):
        return rulebook_decode_plain(values, coords, num, spec)
    out = torch.empty(3 * spec.groups, B, V, dtype=torch.int32,
                      device=coords.device)
    if out.numel():
        _launch_rulebook(DECODE, values.data_ptr(), 0, coords, num, out,
                         spec)
        rulebook_decode.launches += 1
    return out


def lookup_single(packed, grid, qcoords, extra_valid=None):
    """Same contract as ``lookup_single_plain``: one launch of the
    single-cell kernel on CUDA tensors."""
    Z, Y, X = grid
    B = packed.shape[0] if packed.dim() == 2 else -1
    Q = qcoords.shape[1] if qcoords.dim() == 3 else -1
    tensors = [qcoords, packed] + ([] if extra_valid is None
                                   else [extra_valid])
    shapes = [((B, Q, 3), torch.int32), ((B, Z * Y * (X + 2)), torch.int32),
              ((B, Q), torch.bool)]
    if not _check("lookup_single", tensors, shapes):
        return lookup_single_plain(packed, grid, qcoords, extra_valid)
    row = torch.empty(B, Q, dtype=torch.int32, device=qcoords.device)
    found = torch.empty(B, Q, dtype=torch.bool, device=qcoords.device)
    if row.numel():
        err = _fn("rank_lookup_single")(
            packed.data_ptr(), packed.shape[1], qcoords.data_ptr(),
            None if extra_valid is None else extra_valid.data_ptr(),
            row.data_ptr(), found.data_ptr(), B, Q, Z, Y, X,
            cuda_build.stream_of(row))
        cuda_build.check(err, "rank_lookup_single")
        lookup_single.launches += 1
    return row, found


def gather_cells(packed, cell):
    """Same contract as ``gather_cells_plain``. CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    B = packed.shape[0] if packed.dim() == 2 else -1
    G, V = (cell.shape[0], cell.shape[2]) if cell.dim() == 3 else (-1, -1)
    if not _check("gather_cells", [packed, cell],
                  [((B, packed.shape[-1]) if B >= 0 else (-1,), torch.int32),
                   ((G, B, V), torch.int32)]):
        return gather_cells_plain(packed, cell)
    out = torch.empty_like(cell)
    if cell.numel():
        err = _fn("rank_lookup")(packed.data_ptr(), packed.shape[1],
                                 cell.data_ptr(), out.data_ptr(), G, B, V,
                                 cuda_build.stream_of(cell))
        cuda_build.check(err, "rank_lookup")
        gather_cells.launches += 1
    return out


rulebook_rank.launches = 0
rulebook_cells.launches = 0
rulebook_decode.launches = 0
lookup_single.launches = 0
gather_cells.launches = 0
