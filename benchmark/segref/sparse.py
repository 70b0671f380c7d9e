"""Sparse structures, rulebooks and convolutions of the reference, written
from their definitions, not copied from the port.

A structure is a padded set of voxel coordinates [B, V, 3] (z, y, x) whose
first ``num_voxels[b]`` rows are valid (-1 elsewhere). A rulebook
[K, B, Vout] names, for every output voxel and kernel tap (raster order,
x innermost), the flat input row ``b * Vin + row`` of its partner, or the
miss ``B * Vin``: for a submanifold or strided conv the partner sits at
``o * stride + tap - pad``, for the inverse of a strided conv at
``(t + pad - tap) / stride`` where that division is exact. Partners are
found by a binary search of the input structure's sorted voxel keys
(``KeyIndex``), with no table of the grid.

A conv gathers, tap by tap, only the rows that have a partner, multiplies
them by the tap's weights and adds them into the output (``index_add_``).
Autograd derives dX and dW from that, so ``torch.utils.flop_counter``
counts 2 * hits * Cin * Cout for the forward and for each gradient, and
``record_convs`` collects each conv's hits and rows for the benchmark's
roofline.
"""

import threading
from contextlib import contextmanager
from dataclasses import dataclass

import torch

INVALID_KEY = 2**31 - 1  # sorts after every valid key


def _triple(v):
    if isinstance(v, (tuple, list)):
        if len(v) != 3:
            raise ValueError(f"need 3 values, got {v}")
        return tuple(int(x) for x in v)
    return (int(v),) * 3


def valid_rows(num_voxels, V):
    """[B, V] bool: row index < num_voxels[b]."""
    return (torch.arange(V, device=num_voxels.device)[None, :]
            < num_voxels[:, None])


@dataclass
class SparseStructure:
    coords: torch.Tensor  # [B, V, 3] int32 (z, y, x); invalid rows -1
    num_voxels: torch.Tensor  # [B] int32
    spatial_shape: tuple  # (Z, Y, X)

    @property
    def capacity(self):
        return self.coords.shape[1]

    @property
    def batch_size(self):
        return self.coords.shape[0]

    def valid_mask(self):
        return valid_rows(self.num_voxels, self.capacity)


@dataclass
class SparseTensor:
    structure: SparseStructure
    features: torch.Tensor  # [B, V, C]

    def valid_mask(self):
        return self.structure.valid_mask()


def build_structure(coords, num_voxels, spatial_shape):
    total = 1
    for s in spatial_shape:
        total *= int(s)
    if total >= 2**31 - 1:
        raise ValueError(f"grid {spatial_shape} overflows int32 keys")
    return SparseStructure(coords=coords.to(torch.int32),
                           num_voxels=num_voxels.to(torch.int32),
                           spatial_shape=tuple(int(s) for s in spatial_shape))


def linear_keys(coords, spatial_shape):
    _, Y, X = (int(s) for s in spatial_shape)
    c = coords.to(torch.int64)
    return (c[..., 0] * Y + c[..., 1]) * X + c[..., 2]


@dataclass
class KeyIndex:
    """A structure's valid voxels by key: ``keys`` [B, V] ascending
    (INVALID_KEY after the valid ones) and ``rows`` [B, V], the structure
    row of each key."""

    keys: torch.Tensor
    rows: torch.Tensor
    num: torch.Tensor
    spatial_shape: tuple


def dense_table(s: SparseStructure):
    """The lookup index of ``s`` (named after the port's function, whose
    place it takes in the copied backbone)."""
    keys = torch.where(s.valid_mask(), linear_keys(s.coords, s.spatial_shape),
                       INVALID_KEY)
    keys, rows = torch.sort(keys, dim=1)
    return KeyIndex(keys=keys, rows=rows, num=s.num_voxels.to(torch.int64),
                    spatial_shape=s.spatial_shape)


def lookup(index: KeyIndex, q, ok):
    """q [B, M, 3] int coordinates, ok [B, M] bool -> (row [B, M] int64,
    found [B, M] bool): the structure row of the voxel at q, where ok, q
    lies in the grid and that voxel is active."""
    Z, Y, X = index.spatial_shape
    inb = ok & (q[..., 0] >= 0) & (q[..., 0] < Z) & (q[..., 1] >= 0) & (
        q[..., 1] < Y) & (q[..., 2] >= 0) & (q[..., 2] < X)
    key = torch.where(inb, linear_keys(q, index.spatial_shape), -1)
    pos = torch.searchsorted(index.keys, key).clamp(
        max=index.keys.shape[1] - 1)
    found = inb & (torch.gather(index.keys, 1, pos) == key)
    return torch.gather(index.rows, 1, pos), found


def _taps(kernel_size):
    kz, ky, kx = _triple(kernel_size)
    return [(a, b, c) for a in range(kz) for b in range(ky)
            for c in range(kx)]


def _rulebook(index: KeyIndex, out: SparseStructure, kernel_size, stride,
              padding, inverse):
    B, Vin = index.keys.shape
    dev = out.coords.device
    o = out.coords.to(torch.int64)
    ovalid = out.valid_mask()
    st = torch.tensor(_triple(stride), dtype=torch.int64, device=dev)
    pad = torch.tensor(_triple(padding), dtype=torch.int64, device=dev)
    offs = (torch.arange(B, device=dev, dtype=torch.int64) * Vin)[:, None]
    books = []
    for tap in _taps(kernel_size):
        t = torch.tensor(tap, dtype=torch.int64, device=dev)
        if inverse:
            n = o + pad - t
            ok = ovalid & torch.all(n % st == 0, dim=-1)
            q = torch.div(n, st, rounding_mode="floor")
        else:
            ok = ovalid
            q = o * st + t - pad
        row, found = lookup(index, q, ok)
        books.append(torch.where(found, row + offs, B * Vin))
    return torch.stack(books)


def build_subm_rulebook(s: SparseStructure, kernel_size=3, table=None):
    ks = _triple(kernel_size)
    return _rulebook(dense_table(s) if table is None else table, s, ks, 1,
                     tuple(k // 2 for k in ks), inverse=False)


def build_strided_rulebook(s_in: SparseStructure, out_struct, kernel_size=3,
                           stride=2, padding=1, table=None):
    return _rulebook(dense_table(s_in) if table is None else table,
                     out_struct, kernel_size, stride, padding, inverse=False)


def build_inverse_rulebook(s_low: SparseStructure, target_struct,
                           kernel_size=3, stride=2, padding=1, table=None):
    return _rulebook(dense_table(s_low) if table is None else table,
                     target_struct, kernel_size, stride, padding,
                     inverse=True)


def delinearize(keys, spatial_shape):
    _, Y, X = (int(s) for s in spatial_shape)
    z = keys // (Y * X)
    rem = keys % (Y * X)
    c = torch.stack([z, rem // X, rem % X], dim=-1)
    return torch.where((keys == INVALID_KEY)[..., None], -1, c)


def unique_coords(coords, valid_mask, spatial_shape, capacity):
    """The distinct valid coords of each sample, ascending by key, the
    ``capacity`` smallest kept -> (coords [B, capacity, 3], num [B])."""
    keys = torch.where(valid_mask, linear_keys(coords, spatial_shape),
                       INVALID_KEY)
    sk, _ = torch.sort(keys, dim=-1)
    prev = torch.cat([sk.new_full((sk.shape[0], 1), -1), sk[:, :-1]], 1)
    first = (sk != prev) & (sk != INVALID_KEY)
    ranks = torch.cumsum(first.to(torch.int64), dim=1)
    pos = torch.where(first & (ranks <= capacity), ranks - 1, capacity)
    out = sk.new_full((sk.shape[0], capacity + 1), INVALID_KEY)
    out.scatter_(1, pos, sk)
    num = torch.clamp(ranks[:, -1], max=capacity).to(torch.int32)
    return delinearize(out[:, :capacity], spatial_shape).to(torch.int32), num


def downsample_structure(st_struct: SparseStructure, stride, capacity,
                         kernel_size=3, padding=1, rule="decimation"):
    """The output sites of a strided conv: the distinct floor(coords /
    stride), ``capacity`` of them at most."""
    if rule != "decimation":
        raise ValueError(f"the reference builds decimation sites, not {rule}")
    sz3 = _triple(stride)
    out_shape = tuple(-(-d // s) for d, s in zip(st_struct.spatial_shape,
                                                  sz3))
    st = torch.tensor(sz3, dtype=torch.int32, device=st_struct.coords.device)
    coords, num = unique_coords(
        torch.div(st_struct.coords, st, rounding_mode="floor"),
        st_struct.valid_mask(), out_shape, capacity)
    return SparseStructure(coords=coords, num_voxels=num,
                           spatial_shape=out_shape)


_recorder = threading.local()


@contextmanager
def record_convs(records):
    """Append one dict per conv run inside the block to ``records``: its
    taps, widths, hits, the input and output rows it touched, and whether
    autograd will want dX and dW."""
    prev = getattr(_recorder, "records", None)
    _recorder.records = records
    try:
        yield records
    finally:
        _recorder.records = prev


def _conv(features, weights, rulebook):
    B, Vin, Cin = features.shape
    K, _, Vout = rulebook.shape
    flat = features.reshape(B * Vin, Cin)
    miss = B * Vin
    out = features.new_zeros(B * Vout, weights.shape[2])
    hits = 0
    rows_in = torch.zeros(B * Vin + 1, dtype=torch.bool,
                          device=features.device)
    rows_out = torch.zeros(B * Vout, dtype=torch.bool, device=features.device)
    for k in range(K):
        r = rulebook[k].reshape(-1)
        o = torch.nonzero(r != miss).squeeze(1)
        if o.numel() == 0:
            continue
        src = r.index_select(0, o)
        out.index_add_(0, o, flat.index_select(0, src) @ weights[k])
        hits += o.numel()
        rows_in[src] = True
        rows_out[o] = True
    records = getattr(_recorder, "records", None)
    if records is not None:
        records.append(dict(
            K=K, cin=Cin, cout=int(weights.shape[2]), hits=hits,
            rows_in=int(rows_in.sum()), rows_out=int(rows_out.sum()),
            dx=bool(features.requires_grad and torch.is_grad_enabled()),
            dw=bool(weights.requires_grad and torch.is_grad_enabled())))
    return out.reshape(B, Vout, -1)


def subm_conv(st: SparseTensor, weights, rulebook):
    return _conv(st.features, weights, rulebook)


def strided_conv(st: SparseTensor, weights, rulebook, rulebook_t=None):
    return _conv(st.features, weights, rulebook)


def inverse_conv(st_low: SparseTensor, weights, rulebook, rulebook_t=None):
    return _conv(st_low.features, weights, rulebook)


def flat_features(features):
    """[B, V, C] -> [B*V + 1, C] with a trailing zero row for misses."""
    B, V, C = features.shape
    return torch.cat([features.reshape(B * V, C),
                      features.new_zeros(1, C)], dim=0)


def voxel_centers(st_struct: SparseStructure, voxel_size, point_cloud_range):
    """Metric xyz centres of the voxels (invalid rows are garbage)."""
    dev = st_struct.coords.device
    vs = torch.tensor(voxel_size, dtype=torch.float32, device=dev)
    org = torch.tensor(point_cloud_range[:3], dtype=torch.float32, device=dev)
    return (st_struct.coords.to(torch.float32).flip(-1) + 0.5) * vs + org
