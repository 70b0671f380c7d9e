// Rank-table pack for Hopper (sm_90a).
//
// Computes, for an activity bitmap act[nce] of int8 0/1 cells,
//   packed[c] = rank(c) << 3 | act(c-1) << 2 | act(c) << 1 | act(c+1)
// where rank(c) is the inclusive prefix sum of act over [0, c] and the
// neighbours outside [0, nce) count as inactive. This is the RankTable of
// lidarseg3d_torch/ops/coords.py.
//
// Replaces: lidarseg3d_tpu/ops/pallas_rank.py::_pack_kernel (called through
// pack_rank_table). The TPU kernel took per-block offsets precomputed by XLA
// and ran a log-step lane-roll prefix plus a triangular matmul per block.
//
// What bounds it on the H100: bytes. It must read one byte and write four
// per cell (5 B/cell: 6.9 MB for the 1.39 M-cell SemanticKITTI stage-1
// table, 464 MB for a 92.9 M-cell grid) and does one add per cell.
//
// Design: a block scan in three launches behind one C entry point.
//   1. block_counts: each 256-thread block sums its 8192 cells.
//   2. scan_blocks:  one block turns those sums into exclusive offsets.
//   3. pack_write:   each block stages its cells in shared memory, takes a
//      32-cell serial prefix per thread, scans the thread totals with warp
//      shuffles, adds its block offset, and builds the neighbour bits from
//      shared memory (block edges read act[c-1] / act[c+1] from global
//      memory). Results are staged in padded shared memory and stored
//      coalesced. Blocks are independent after step 2, so the act bitmap
//      is read twice and the table written once: 6 B/cell in all.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 32;
constexpr int kBlock = kThreads * kPerThread;  // 8192 cells per block
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ int warp_inclusive_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += n;
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
block_counts(const int8_t* __restrict__ act, long long nce,
             int* __restrict__ tot) {
  const long long base = (long long)blockIdx.x * kBlock;
  int s = 0;
  for (int i = threadIdx.x; i < kBlock; i += kThreads) {
    const long long c = base + i;
    if (c < nce) s += act[c];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  __shared__ int wsum[kWarps];
  if ((threadIdx.x & 31) == 0) wsum[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = 0;
    for (int w = 0; w < kWarps; ++w) t += wsum[w];
    tot[blockIdx.x] = t;
  }
}

// One block of 1024 threads: offs[i] = sum_{j<i} tot[j], offs[nb] = total.
__global__ void __launch_bounds__(1024)
scan_blocks(const int* __restrict__ tot, int nb, int* __restrict__ offs) {
  const int per = (nb + blockDim.x - 1) / blockDim.x;
  const int start = threadIdx.x * per;
  const int end = min(start + per, nb);
  int s = 0;
  for (int i = start; i < end; ++i) s += tot[i];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int incl = warp_inclusive_scan(s);
  __shared__ int wsum[32];
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  if (warp == 0) wsum[lane] = warp_inclusive_scan(wsum[lane]);
  __syncthreads();
  int run = incl - s + (warp > 0 ? wsum[warp - 1] : 0);
  for (int i = start; i < end; ++i) {
    offs[i] = run;
    run += tot[i];
  }
  if (threadIdx.x == blockDim.x - 1) offs[nb] = run;
}

__global__ void __launch_bounds__(kThreads)
pack_write(const int8_t* __restrict__ act, long long nce,
           const int* __restrict__ offs, int* __restrict__ out) {
  __shared__ int8_t s_act[kBlock];
  __shared__ int s_out[kThreads * (kPerThread + 1)];  // +1: no bank clash
  __shared__ int wsum[kWarps];
  const long long base = (long long)blockIdx.x * kBlock;
  for (int i = threadIdx.x; i < kBlock; i += kThreads) {
    const long long c = base + i;
    s_act[i] = c < nce ? act[c] : (int8_t)0;
  }
  __syncthreads();

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int8_t* mine = s_act + t * kPerThread;
  int s = 0;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) s += mine[j];
  const int incl = warp_inclusive_scan(s);
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int v = warp_inclusive_scan(lane < kWarps ? wsum[lane] : 0);
    if (lane < kWarps) wsum[lane] = v;
  }
  __syncthreads();
  int run = offs[blockIdx.x] + (warp > 0 ? wsum[warp - 1] : 0) + incl - s;

  int prev = t > 0 ? (int)mine[-1] : (base > 0 ? (int)act[base - 1] : 0);
  int after = 0;  // act of the cell just past this thread's run
  if (t < kThreads - 1) {
    after = mine[kPerThread];
  } else if (base + kBlock < nce) {
    after = act[base + kBlock];
  }
  int* dst = s_out + t * (kPerThread + 1);
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int cur = mine[j];
    const int nxt = j < kPerThread - 1 ? (int)mine[j + 1] : after;
    run += cur;
    dst[j] = (run << 3) | (prev << 2) | (cur << 1) | nxt;
    prev = cur;
  }
  __syncthreads();
  for (int i = t; i < kBlock; i += kThreads) {
    const long long c = base + i;
    if (c < nce) out[c] = s_out[(i >> 5) * (kPerThread + 1) + (i & 31)];
  }
}

}  // namespace

// act [nce] int8, tot [nb] int32 scratch, offs [nb + 1] int32 scratch,
// out [nce] int32, with nb = ceil(nce / 8192) and nce > 0.
extern "C" int rank_pack(const void* act, long long nce, void* tot,
                         void* offs, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long nb = (nce + kBlock - 1) / kBlock;
  if (nce <= 0 || nb > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  block_counts<<<(unsigned)nb, kThreads, 0, st>>>(
      static_cast<const int8_t*>(act), nce, static_cast<int*>(tot));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_blocks<<<1, 1024, 0, st>>>(static_cast<const int*>(tot), (int)nb,
                                  static_cast<int*>(offs));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pack_write<<<(unsigned)nb, kThreads, 0, st>>>(
      static_cast<const int8_t*>(act), nce, static_cast<const int*>(offs),
      static_cast<int*>(out));
  return (int)cudaGetLastError();
}
