// Sorted-keys merge lookup for Hopper (sm_90a): a variant that searches
// device memory only, kept to be measured against the shipped kernel
// (../merge_lookup.cu, a key window per block in shared memory) by
// profile_merge.py. Not built by the package.
//
// For query cells cell [G, B, V] int32 and per-sample sorted voxel keys
// keys [B, Vk] int32 (ascending and distinct in the first num[b] entries),
// computes what a packed rank-table gather returns at each query q:
//
//   out = (rank << 3) | act(q-1) << 2 | act(q) << 1 | act(q+1)
//
// with rank = #{valid keys <= q} and act(c) = (c is a valid key). This is
// the rulebook lookup of grids too large for a dense table (lidarseg3d_
// torch/ops/sparse.py lookup_rank3_cells on a KeyTable).
//
// Replaces: lidarseg3d_tpu/ops/pallas_merge.py::_merge_kernel (through
// merge_gather). The TPU kernel walked 1024-query tiles over 1024-key VMEM
// chunks picked by per-tile anchors computed in XLA and needed the query
// stream monotone within a tile. This kernel takes any query order.
//
// What bounds it on the H100: bytes. Each query reads 4 B of cell and
// writes 4 B of result; the keys (160 KB at V=40960) and block ranks are
// read once from device memory. In practice a query's time is its chain
// of dependent loads: its cell, its block ranks, the probes of its search
// and its neighbour keys. Keys and block ranks are read through the L1
// cache (__ldg), where the probes of nearby queries hit.
//
// Design: each thread answers kPer queries of one (group, sample) row
// (blockIdx.y = g*B + b), 256 apart so that loads and stores stay
// coalesced. For each query the KeyTable's block ranks coarse[b][j] =
// #{valid keys < j << shift} of the block j that holds q+1 bracket the
// search: #{valid keys <= q+1} lies in [coarse[j], coarse[j+1]], a few
// keys on the main paths' grids. A thread's searches run interleaved,
// branch-free over powers of two, so that their probes are in flight
// together; then each reads the three keys below its position at once and
// decides act(q+1), act(q) and act(q-1) from them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 2;                      // queries a thread
constexpr int kTile = kThreads * kPer;       // 512 queries a block

__global__ void __launch_bounds__(kThreads)
merge_lookup_kernel(const int* __restrict__ keys, long long vk,
                    const int* __restrict__ coarse, long long nb, int shift,
                    const int* __restrict__ num, const int* __restrict__ cell,
                    int* __restrict__ out, long long V, int B) {
  const int t = threadIdx.x;
  const long long row = blockIdx.y;
  const int b = (int)(row % B);
  const int* __restrict__ k = keys + (long long)b * vk;
  const int* __restrict__ cb = coarse + (long long)b * (nb + 1);
  long long n = __ldg(num + b);
  n = n < 0 ? 0 : (n > vk ? vk : n);
  const int* __restrict__ q_in = cell + row * V;
  int* __restrict__ o = out + row * V;
  const long long v0 = (long long)blockIdx.x * kTile;

  int q[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const long long v = v0 + i * kThreads + t;
    q[i] = v < V ? __ldg(q_in + v) : 0;
  }
  // each query's bracket [lo, lo + cnt) of key positions
  long long lo[kPer];
  int cnt[kPer], pos[kPer];
  int widest = 0;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const long long qp = (long long)q[i] + 1;
    const long long j = qp >> shift;
    long long l = qp < 0 ? 0 : n, h = l;
    if (qp >= 0 && j < nb) {
      l = __ldg(cb + j);
      h = __ldg(cb + j + 1);
      l = l > n ? n : l;
      h = h > n ? n : h;
    }
    lo[i] = l;
    cnt[i] = v0 + i * kThreads + t < V ? (int)(h - l) : 0;
    pos[i] = 0;
    widest = max(widest, cnt[i]);
  }
  // pos = #{k[lo, lo + cnt) <= q+1}
  for (int step = widest ? 1 << (31 - __clz(widest)) : 0; step > 0;
       step >>= 1) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int p = pos[i] + step;
      if (p <= cnt[i] &&
          (long long)__ldg(k + lo[i] + p - 1) <= (long long)q[i] + 1)
        pos[i] = p;
    }
  }
  // the rank is #{keys <= q+1} less act(q+1); the three keys below that
  // count decide the neighbour bits, as _merge_kernel's checks after its
  // search do
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const long long v = v0 + i * kThreads + t;
    if (v >= V) continue;
    const long long qq = q[i], p = lo[i] + pos[i];
    const long long none = -(1ll << 40);  // equals no cell
    const long long x1 = p >= 1 ? __ldg(k + p - 1) : none;
    const long long x2 = p >= 2 ? __ldg(k + p - 2) : none;
    const long long x3 = p >= 3 ? __ldg(k + p - 3) : none;
    const int ap = x1 == qq + 1;
    const long long y1 = ap ? x2 : x1, y2 = ap ? x3 : x2;
    const int a0 = y1 == qq;
    const int am = (a0 ? y2 : y1) == qq - 1;
    o[v] = ((int)(p - ap) << 3) | (am << 2) | (a0 << 1) | ap;
  }
}

}  // namespace

// keys [B, vk], coarse [B, nb + 1], num [B], cell/out [G, B, V], all int32
// and contiguous; every valid key is below nb << shift.
extern "C" int merge_lookup(const void* keys, long long vk, const void* coarse,
                            long long nb, int shift, const void* num,
                            const void* cell, void* out, long long G,
                            long long B, long long V, void* stream) {
  const long long rows = G * B;
  if (rows <= 0 || rows > 65535 || V <= 0 || vk <= 0 || nb <= 0 ||
      shift < 0 || shift > 30 || vk >= (1ll << 28))
    return (int)cudaErrorInvalidValue;
  const long long bx = (V + kTile - 1) / kTile;
  if (bx > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  merge_lookup_kernel<<<dim3((unsigned)bx, (unsigned)rows), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(keys), vk, static_cast<const int*>(coarse), nb,
      shift, static_cast<const int*>(num), static_cast<const int*>(cell),
      static_cast<int*>(out), V, (int)B);
  return (int)cudaGetLastError();
}
