// Sorted-keys merge lookup for Hopper (sm_90a).
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
// stream monotone within a tile. This kernel stages each tile's keys in
// shared memory itself and takes any query order.
//
// What bounds it on the H100: bytes. Each query reads 4 B of cell and
// writes 4 B of result; the keys (160 KB at V=40960) and block ranks are
// read once from device memory. In practice a tile's time is its chain of
// dependent loads: its cells, the block ranks, the keys, the searches.
//
// Design: a block answers a tile of kTile queries of one (group, sample)
// row (blockIdx.y = g*B + b), kPer a thread, kThreads apart, so loads and
// stores stay coalesced. The KeyTable's block ranks coarse[b][j] =
// #{valid keys < j << shift} bracket each query: #{valid keys <= q+1} lies
// in [l, h] = [coarse[j], coarse[j+1]] for the block j that holds q+1, and
// the three keys below that count decide the neighbour bits, so a query
// reads key positions [l - 3, h).
//   - Window: the block reduces its tile's smallest and largest query,
//     brackets them, and stages key positions [w0, w1) = [l(min) - 3,
//     h(max)) in shared memory in one coalesced pass, cut to kWindow keys.
//     On the main paths' streams (key-sorted voxel cells plus one offset,
//     clipped and clamped per row) a tile spans about kTile keys and
//     every query is served from the window.
//   - A query whose bracket ends beyond the (cut) window is searched in
//     device memory instead, in the same loop: a shuffled stream, or a
//     tile that straddles a row's last voxels and its padding. An optional
//     counter (paths) adds up tiles by path: every query in the window,
//     some, none; and the queries searched in device memory.
//   - A thread's kPer searches run interleaved, branch-free over powers of
//     two, then each reads the three keys below its position at once and
//     decides act(q+1), act(q) and act(q-1) from them.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

#ifndef MERGE_KPER
#define MERGE_KPER 2
#endif
#ifndef MERGE_WINDOW
#define MERGE_WINDOW 1024
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = MERGE_KPER;          // queries a thread
constexpr int kTile = kThreads * kPer;    // queries a block
constexpr int kWindow = MERGE_WINDOW;     // keys a block stages
static_assert(kWindow % kThreads == 0, "the copy takes whole rounds");

// [l, h]: the key positions between which #{valid keys <= q+1} lies
__device__ __forceinline__ void bracket(long long q, const int* cb,
                                        long long nb, int shift,
                                        long long n, long long* l,
                                        long long* h) {
  const long long qp = q + 1;
  const long long j = qp >> shift;
  if (qp < 0) {
    *l = *h = 0;
  } else if (j >= nb) {
    *l = *h = n;
  } else {
    const long long a = __ldg(cb + j), b = __ldg(cb + j + 1);
    *l = a > n ? n : a;
    *h = b > n ? n : b;
  }
}

__global__ void __launch_bounds__(kThreads)
merge_lookup_kernel(const int* __restrict__ keys, long long vk,
                    const int* __restrict__ coarse, long long nb, int shift,
                    const int* __restrict__ num, const int* __restrict__ cell,
                    int* __restrict__ out, long long V, int B,
                    unsigned long long* paths) {
  __shared__ int s_keys[kWindow];
  __shared__ int s_min[kWarps], s_max[kWarps];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
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
  bool ok[kPer];
  int qmin = INT_MAX, qmax = INT_MIN;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const long long v = v0 + i * kThreads + t;
    ok[i] = v < V;
    q[i] = ok[i] ? __ldg(q_in + v) : 0;
    if (ok[i]) {
      qmin = min(qmin, q[i]);
      qmax = max(qmax, q[i]);
    }
  }
  // each query's bracket, loaded while the block agrees on its window
  long long lo[kPer], hi[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    bracket(q[i], cb, nb, shift, n, &lo[i], &hi[i]);
  qmin = __reduce_min_sync(0xffffffffu, qmin);
  qmax = __reduce_max_sync(0xffffffffu, qmax);
  if (lane == 0) {
    s_min[warp] = qmin;
    s_max[warp] = qmax;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    qmin = min(qmin, s_min[w]);
    qmax = max(qmax, s_max[w]);
  }
  long long wl, wh, unused;
  bracket(qmin, cb, nb, shift, n, &wl, &unused);
  bracket(qmax, cb, nb, shift, n, &unused, &wh);
  const long long w0 = wl > 3 ? wl - 3 : 0;
  const long long w1 = wh < w0 + kWindow ? wh : w0 + kWindow;
#pragma unroll
  for (int c = 0; c < kWindow / kThreads; ++c) {
    const long long i = w0 + c * kThreads + t;
    if (i < w1) s_keys[i - w0] = __ldg(k + i);
  }
  __syncthreads();

  // a query's keys come from the window when its bracket ends inside it
  // (it starts inside: l - 3 >= w0 for every query of the tile, and a
  // position below 0 holds no key); pos = #{keys [l, h) <= q+1}
  const int* src[kPer];
  int cnt[kPer], pos[kPer];
  int widest = 0, global = 0;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const bool win = hi[i] <= w1;
    src[i] = win ? s_keys + (lo[i] - w0) : k + lo[i];
    cnt[i] = ok[i] ? (int)(hi[i] - lo[i]) : 0;
    pos[i] = 0;
    widest = max(widest, cnt[i]);
    global += ok[i] && !win;
  }
  for (int step = widest ? 1 << (31 - __clz(widest)) : 0; step > 0;
       step >>= 1) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int p = pos[i] + step;
      if (p <= cnt[i] && (long long)src[i][p - 1] <= (long long)q[i] + 1)
        pos[i] = p;
    }
  }
  // the rank is #{keys <= q+1} less act(q+1); the three keys below that
  // count decide the neighbour bits, as _merge_kernel's checks after its
  // search do
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    if (!ok[i]) continue;
    const long long qq = q[i], p = lo[i] + pos[i];
    const long long none = -(1ll << 40);  // equals no cell
    const long long x1 = p >= 1 ? src[i][pos[i] - 1] : none;
    const long long x2 = p >= 2 ? src[i][pos[i] - 2] : none;
    const long long x3 = p >= 3 ? src[i][pos[i] - 3] : none;
    const int ap = x1 == qq + 1;
    const long long y1 = ap ? x2 : x1, y2 = ap ? x3 : x2;
    const int a0 = y1 == qq;
    const int am = (a0 ? y2 : y1) == qq - 1;
    o[v0 + i * kThreads + t] = ((int)(p - ap) << 3) | (am << 2) | (a0 << 1) |
                               ap;
  }

  if (paths != nullptr) {  // the same for every thread of the launch
    int valid = 0;
#pragma unroll
    for (int i = 0; i < kPer; ++i) valid += ok[i];
    const int some_out = __syncthreads_or(global > 0);
    const int some_in = __syncthreads_or(valid > global);
    const int warp_global = __reduce_add_sync(0xffffffffu, global);
    if (t == 0) atomicAdd(paths + (!some_out ? 0 : some_in ? 1 : 2), 1ull);
    if (lane == 0 && warp_global)
      atomicAdd(paths + 3, (unsigned long long)warp_global);
  }
}

}  // namespace

// keys [B, vk], coarse [B, nb + 1], num [B], cell/out [G, B, V], all int32
// and contiguous; every valid key is below nb << shift. paths: null, or 4
// uint64 counters the kernel adds to: tiles served wholly from their
// window, partly, not at all, and the queries searched in device memory.
extern "C" int merge_lookup(const void* keys, long long vk, const void* coarse,
                            long long nb, int shift, const void* num,
                            const void* cell, void* out, long long G,
                            long long B, long long V, void* paths,
                            void* stream) {
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
      static_cast<int*>(out), V, (int)B,
      static_cast<unsigned long long*>(paths));
  return (int)cudaGetLastError();
}
