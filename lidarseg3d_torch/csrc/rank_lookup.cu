// Rank-table lookups for Hopper (sm_90a): the fused rulebook build, its
// front end and decode around the merge kernel, the single-cell lookup, and
// the plain grouped gather.
//
// Replaces: lidarseg3d_tpu/ops/pallas_lookup.py::_lookup_kernel (through
// lookup_gather) and its HBM-resident variant _hbm_kernel
// (_lookup_gather_hbm), together with the XLA glue of
// lidarseg3d_tpu/ops/sparse.py around them (_gather_cells, :251-279, and
// the query stacks, bounds, clips, bit decodes, flattens and tap stacks of
// the rulebook builders, :311-349, :352, :478, :563). The TPU kernels had
// to receive a precomputed, monotone stream of query cells in 1024-query
// tiles, because they walked VMEM windows; the rulebook around them was
// some ninety small XLA operations. A GPU thread loads any table element,
// so here a thread reads its own row's coordinates, forms its query,
// reads the packed value and writes three rulebook entries: one launch per
// rulebook, no intermediate tensor, no host-to-device copy of offsets.
//
// Kernels (all int32, contiguous):
//   rulebook_lookup phase kFused  - packed [B, nce] -> rulebook [K, B, V];
//                   phase kCells  - query cells [G, B, V] for the merge
//                                   kernel (csrc/merge_lookup.cu);
//                   phase kDecode - the merge's packed values [G, B, V]
//                                   -> rulebook [K, B, V];
//   rank_lookup_single            - own-cell lookup (row, found) [B, Q];
//   rank_lookup                   - out[g, b, v] = packed[b, cell[g, b, v]].
// K = 3 G, G = kz ky groups g = dz ky + dy of three x-taps; a rulebook
// entry is b v_in + row, a miss B v_in. A query is, per group,
//   subm / strided: (o_z sz + dz - pz, o_y sy + dy - py, o_x sx + 1 - px)
//                   (a subm rulebook is stride 1, padding (kz/2, ky/2, 1));
//   inverse:        numerators t + p - d for z and y, valid iff divisible by
//                   the stride, the floor quotient, and x centre n0 - 1
//                   (sx = 1) or floor((n0 - 1) / 2) (sx = 2), n0 = t_x + px,
// with inb = row valid && z in [0, Z) && y in [0, Y) && x in [-1, X] on the
// x-extended grid, cell = (z Y + y)(X + 2) + x + 1. A masked query's
// entries are misses whatever its cell holds, so the fused kernel reads no
// table for it and the front end hands the merge the cell of its query
// with each coordinate clamped into the grid: a near-monotone stream with
// no per-row reduction (the clamp of sparse.kernel_cells changes only
// masked queries). torch's floor division and modulo are written out: C's
// truncate, which differs on negative numerators at the grid's low faces.
//
// What bounds it on the H100: bytes. A row reads 12 B of coordinates and
// writes K 4 B rulebook entries; the table traffic is the 32 B sectors
// the in-bounds queries touch. SemanticKITTI's subm1 (V = 131072, K = 27)
// writes 14.2 MB and reads 1.6 MB of coordinates plus at most 5.5 MB of
// table: about 6 us at 3.35 TB/s. The design reaches for that bound by
// one pass: a 2-D grid whose blockIdx.y is the (group, sample) row g B + b
// (one division a block), threads over the row's voxels, so neighbouring
// threads read neighbouring coordinates and store neighbouring words of
// each of the three tap planes; key-sorted rows keep neighbouring queries
// on neighbouring cells, and a stage table stays in the 50 MB L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocksX = 4096;
enum Phase { kFused = 0, kCells = 1, kDecode = 2 };

// One rulebook's geometry (lidarseg3d_torch/ops/rank_lookup.py RulebookSpec).
struct Spec {
  int inverse, ky;
  int sz, sy, sx;
  int pz, py, px;
  int Z, Y, X;
  int v_in;
};

struct Query {
  int cell;   // on the x-extended grid, coordinates clamped into it
  bool inb;   // the query hits a cell of the grid from a valid row
  bool even;  // inverse, sx = 2: n0 is even
};

__device__ __forceinline__ int floordiv(int a, int s) {
  return a >= 0 ? a / s : -((s - 1 - a) / s);
}

// floor division and exact-division test by a stride; the main path's
// strides are 2, where a shift and a mask replace the divisions
__device__ __forceinline__ int floordiv_by(int a, int s) {
  return s == 2 ? a >> 1 : floordiv(a, s);
}

__device__ __forceinline__ bool divides(int s, int a) {
  return s == 2 ? (a & 1) == 0 : a % s == 0;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// The query of group (dz, dy) for a row at (tz, ty, tx).
__device__ __forceinline__ Query make_query(const Spec& s, int dz, int dy,
                                            int tz, int ty, int tx,
                                            bool valid) {
  int z, y, x;
  Query q;
  q.even = true;
  if (!s.inverse) {
    z = tz * s.sz + dz - s.pz;
    y = ty * s.sy + dy - s.py;
    x = tx * s.sx + 1 - s.px;
  } else {
    const int nz = tz + s.pz - dz, ny = ty + s.py - dy, n0 = tx + s.px;
    valid = valid && divides(s.sz, nz) && divides(s.sy, ny);
    z = floordiv_by(nz, s.sz);
    y = floordiv_by(ny, s.sy);
    x = s.sx == 1 ? n0 - 1 : (n0 - 1) >> 1;
    q.even = (n0 & 1) == 0;
  }
  q.inb = valid && z >= 0 && z < s.Z && y >= 0 && y < s.Y && x >= -1 &&
          x <= s.X;
  q.cell = (clampi(z, 0, s.Z - 1) * s.Y + clampi(y, 0, s.Y - 1)) *
               (s.X + 2) +
           clampi(x, -1, s.X) + 1;
  return q;
}

// The three taps of group g from packed value v (rank << 3 | act(c-1) << 2
// | act(c) << 1 | act(c+1)), stored at out[3g + t, b, v] = o[t * plane].
__device__ __forceinline__ void write_taps(int* __restrict__ o,
                                           long long plane, int val,
                                           const Query& q, const Spec& s,
                                           int off, int miss) {
  const int rank = val >> 3, am = (val >> 2) & 1, a0 = (val >> 1) & 1,
            ap = val & 1;
  const int gm = q.inb && am ? rank - a0 - 1 + off : miss;
  const int g0 = q.inb && a0 ? rank - 1 + off : miss;
  const int gp = q.inb && ap ? rank + ap - 1 + off : miss;
  int t0 = gm, t1 = g0, t2 = gp;
  if (s.inverse) {
    if (s.sx == 1) {  // dx = 0 at cell n0, 1 at n0 - 1, 2 at n0 - 2
      t0 = gp;
      t2 = gm;
    } else {  // even n0: dx = 0 at n0 / 2, dx = 2 at n0 / 2 - 1; odd: dx = 1
      t0 = q.even ? gp : miss;
      t1 = q.even ? miss : g0;
      t2 = q.even ? g0 : miss;
    }
  }
  o[0] = t0;
  o[plane] = t1;
  o[2 * plane] = t2;
}

template <int kPhase>
__global__ void __launch_bounds__(kThreads)
rulebook_kernel(const int* __restrict__ src, long long nce,
                const int* __restrict__ coords, const int* __restrict__ num,
                int* __restrict__ out, int B, long long V, Spec s) {
  const int row = blockIdx.y;  // g * B + b
  const int g = row / B, b = row - g * B;
  const int dz = g / s.ky, dy = g - dz * s.ky;
  const long long nv = __ldg(num + b);
  const long long plane = (long long)B * V;
  const int off = b * s.v_in, miss = B * s.v_in;
  const int* __restrict__ c = coords + (long long)b * V * 3;
  const int* __restrict__ table = src + (long long)b * nce;
  const int* __restrict__ vals = src + (long long)row * V;
  int* __restrict__ o = out + ((long long)3 * g * B + b) * V;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x; v < V;
       v += stride) {
    const Query q = make_query(s, dz, dy, __ldg(c + 3 * v),
                               __ldg(c + 3 * v + 1), __ldg(c + 3 * v + 2),
                               v < nv);
    if (kPhase == kCells) {
      out[(long long)row * V + v] = q.cell;
      continue;
    }
    int val = 0;
    if (q.inb) val = kPhase == kFused ? __ldg(table + q.cell) : __ldg(vals + v);
    write_taps(o + v, plane, val, q, s, off, miss);
  }
}

__global__ void __launch_bounds__(kThreads)
single_kernel(const int* __restrict__ packed, long long nce,
              const int* __restrict__ q, const unsigned char* __restrict__ extra,
              int* __restrict__ row, unsigned char* __restrict__ found,
              long long Q, int Z, int Y, int X) {
  const int b = blockIdx.y;
  const int* __restrict__ table = packed + (long long)b * nce;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < Q;
       i += stride) {
    const long long j = (long long)b * Q + i;
    const int z = __ldg(q + 3 * j), y = __ldg(q + 3 * j + 1),
              x = __ldg(q + 3 * j + 2);
    bool inb = z >= 0 && z < Z && y >= 0 && y < Y && x >= 0 && x < X;
    if (extra != nullptr) inb = inb && __ldg(extra + j);
    // int32 arithmetic that wraps as torch's does, then the clip
    const int cell = (int)(((unsigned)z * (unsigned)Y + (unsigned)y) *
                               (unsigned)(X + 2) +
                           (unsigned)x + 1u);
    const long long c = min(max((long long)cell, 0LL), nce - 1);
    const int val = __ldg(table + c);
    row[j] = (val >> 3) - 1;
    found[j] = inb && ((val >> 1) & 1);
  }
}

__global__ void __launch_bounds__(kThreads)
gather_cells(const int* __restrict__ packed, long long nce,
             const int* __restrict__ cell, int* __restrict__ out,
             long long V, int B) {
  const long long row = blockIdx.y;
  const int* __restrict__ table = packed + (long long)(blockIdx.y % B) * nce;
  const int* __restrict__ q = cell + row * V;
  int* __restrict__ o = out + row * V;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x; v < V;
       v += stride) {
    const int c = __ldg(q + v);
    o[v] = (c >= 0 && c < nce) ? __ldg(table + c) : 0;
  }
}

dim3 grid_of(long long n, long long rows) {
  long long bx = (n + kThreads - 1) / kThreads;
  if (bx > kMaxBlocksX) bx = kMaxBlocksX;
  return dim3((unsigned)bx, (unsigned)rows);
}

}  // namespace

// phase 0 (fused): src = packed [B, nce], out = rulebook [3G, B, V];
// phase 1 (cells): src unused, out = cells [G, B, V];
// phase 2 (decode): src = packed values [G, B, V], out = rulebook.
// coords [B, V, 3] and num [B] describe the query structure.
extern "C" int rulebook_lookup(int phase, const void* src, long long nce,
                               const void* coords, const void* num, void* out,
                               long long G, long long B, long long V,
                               int inverse, int ky, int sz, int sy, int sx,
                               int pz, int py, int px, int Z, int Y, int X,
                               long long v_in, void* stream) {
  const long long rows = G * B;
  if (rows <= 0 || rows > 65535 || V <= 0 || ky <= 0 || G % ky != 0 ||
      sz <= 0 || sy <= 0 || (inverse && sx != 1 && sx != 2) || Z <= 0 ||
      Y <= 0 || X <= 0 || v_in < 0 || B * v_in > 0x7fffffffLL ||
      (phase == kFused && nce != (long long)Z * Y * (X + 2)))
    return (int)cudaErrorInvalidValue;
  const Spec s{inverse, ky, sz, sy, sx, pz, py, px, Z, Y, X, (int)v_in};
  const dim3 grid = grid_of(V, rows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sp = static_cast<const int*>(src);
  const int* cp = static_cast<const int*>(coords);
  const int* np = static_cast<const int*>(num);
  int* op = static_cast<int*>(out);
  if (phase == kFused)
    rulebook_kernel<kFused><<<grid, kThreads, 0, st>>>(sp, nce, cp, np, op,
                                                       (int)B, V, s);
  else if (phase == kCells)
    rulebook_kernel<kCells><<<grid, kThreads, 0, st>>>(sp, nce, cp, np, op,
                                                       (int)B, V, s);
  else if (phase == kDecode)
    rulebook_kernel<kDecode><<<grid, kThreads, 0, st>>>(sp, nce, cp, np, op,
                                                        (int)B, V, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// packed [B, nce], q [B, Q, 3], extra [B, Q] bool or null -> row [B, Q]
// int32, found [B, Q] bool.
extern "C" int rank_lookup_single(const void* packed, long long nce,
                                  const void* q, const void* extra, void* row,
                                  void* found, long long B, long long Q, int Z,
                                  int Y, int X, void* stream) {
  if (B <= 0 || B > 65535 || Q <= 0 || nce != (long long)Z * Y * (X + 2) ||
      nce <= 0)
    return (int)cudaErrorInvalidValue;
  single_kernel<<<grid_of(Q, B), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(packed), nce, static_cast<const int*>(q),
      static_cast<const unsigned char*>(extra), static_cast<int*>(row),
      static_cast<unsigned char*>(found), Q, Z, Y, X);
  return (int)cudaGetLastError();
}

// packed [B, nce], cell/out [G, B, V], all int32 and contiguous.
extern "C" int rank_lookup(const void* packed, long long nce, const void* cell,
                           void* out, long long G, long long B, long long V,
                           void* stream) {
  const long long rows = G * B;
  if (rows <= 0 || rows > 65535 || V <= 0 || nce <= 0)
    return (int)cudaErrorInvalidValue;
  gather_cells<<<grid_of(V, rows), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(packed), nce, static_cast<const int*>(cell),
      static_cast<int*>(out), V, (int)B);
  return (int)cudaGetLastError();
}
