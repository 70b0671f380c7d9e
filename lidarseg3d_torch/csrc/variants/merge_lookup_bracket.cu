// Sorted-keys merge lookup for Hopper (sm_90a): the first port's kernel
// (one query a thread, one search of its bracket in device memory), kept
// to be measured against the shipped kernel (../merge_lookup.cu) by
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
// chunks picked by per-tile anchors computed in XLA, resolved each chunk
// read in eight sublane rounds (_fetch), and needed the query stream
// monotone within a tile. A GPU thread reads any key from device memory,
// so none of that carries over: one thread per query binary-searches its
// sample's keys directly, in any query order.
//
// The search is narrowed by the KeyTable's block ranks: coarse[b][j] =
// #{valid keys < j << shift}, so #{valid keys <= q+1} lies in
// [coarse[j], coarse[j+1]] for j = (q+1) >> shift. At shift 12 that is a
// few keys per block on the 0.1 m grids instead of all num of them.
//
// What bounds it on the H100: bytes. Each query reads 4 B of cell and
// writes 4 B of result; the keys (160 KB at V=40960) and block ranks are
// read once from device memory and then served from L2 to the dependent
// loads of every search.
//
// Design: the upper bound pos = #{valid keys <= q+1}, then the top
// positions are checked for q+1, q and q-1 in turn, as _merge_kernel does
// after its search. A 2-D grid, blockIdx.y the (group, sample) row
// g*B + b, as in rank_lookup.cu.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void __launch_bounds__(256)
merge_lookup_kernel(const int* __restrict__ keys, long long vk,
                    const int* __restrict__ coarse, long long nb, int shift,
                    const int* __restrict__ num, const int* __restrict__ cell,
                    int* __restrict__ out, long long V, int B) {
  const long long row = blockIdx.y;
  const int b = (int)(row % B);
  const int* __restrict__ k = keys + (long long)b * vk;
  const int* __restrict__ cb = coarse + (long long)b * (nb + 1);
  long long n = __ldg(num + b);
  n = n < 0 ? 0 : (n > vk ? vk : n);
  const int* __restrict__ q_in = cell + row * V;
  int* __restrict__ o = out + row * V;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x; v < V;
       v += stride) {
    const long long q = __ldg(q_in + v);
    const long long qp = q + 1;
    // pos = #{k[0:n] <= q+1}, bracketed by the block ranks of q+1's block
    const long long j = qp < 0 ? -1 : (qp >> shift);
    long long lo, hi;
    if (j < 0) {
      lo = hi = 0;
    } else if (j >= nb) {
      lo = hi = n;
    } else {
      lo = __ldg(cb + j);
      hi = __ldg(cb + j + 1);
      lo = lo > n ? n : lo;
      hi = hi > n ? n : hi;
    }
    while (lo < hi) {
      const long long mid = (lo + hi) >> 1;
      if ((long long)__ldg(k + mid) <= qp) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    const long long pos = lo;
    const int ap = (pos >= 1 && (long long)__ldg(k + pos - 1) == qp) ? 1 : 0;
    const long long i2 = pos - 1 - ap;
    const int a0 = (i2 >= 0 && (long long)__ldg(k + i2) == q) ? 1 : 0;
    const long long i3 = i2 - a0;
    const int am = (i3 >= 0 && (long long)__ldg(k + i3) == q - 1) ? 1 : 0;
    const int rank = (int)(pos - ap);
    o[v] = (rank << 3) | (am << 2) | (a0 << 1) | ap;
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
      shift < 0 || shift > 30)
    return (int)cudaErrorInvalidValue;
  long long bx = (V + 255) / 256;
  if (bx > 4096) bx = 4096;
  merge_lookup_kernel<<<dim3((unsigned)bx, (unsigned)rows), 256, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(keys), vk, static_cast<const int*>(coarse), nb,
      shift, static_cast<const int*>(num), static_cast<const int*>(cell),
      static_cast<int*>(out), V, (int)B);
  return (int)cudaGetLastError();
}
