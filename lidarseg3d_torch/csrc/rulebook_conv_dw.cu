// Weight gradient of the rulebook sparse convolution for Hopper (sm_90a).
//
// Computes dW[k, ci, co] = sum_m feat[rb[k, m], ci] * gout[m, co] for
//   feat [N + 1, Cin]  flat voxel features, last row all zeros,
//   rb   [K, M] int32  global flat partner rows, a miss is N (the zero row),
//   gout [M, Cout]     the output cotangent,
//   dW   [K, Cin, Cout] fp32,
// with feat and gout in fp32 or bf16 and fp32 accumulation: the gradient of
// rulebook_conv.cu's product with respect to w.
//
// Replaces: lidarseg3d_tpu/ops/pallas_conv.py::_dw_kernel (through
// rulebook_conv_dw as wired by ops/sparse_pallas.py::_dw_many). The TPU
// kernel walked 128-lane output blocks in grid order, re-gathered an im2col
// block [K*Cin, 128] into VMEM and carried one [K*Cin, Cout] accumulator in
// scratch from grid step to grid step. Blocks of a GPU grid run in no order
// and share no accumulator, so that sequential sum becomes a two-level one
// here; the window metadata, the im2col scratch, the Cin chunking to 8 and
// the column chunks of the TPU wiring exist for VMEM/SMEM and do not carry
// over.
//
// What bounds it on the H100: per (output row, partner) pair the useful
// work is 2*Cin*Cout flops, the same as the forward; the bytes are the
// distinct partner rows, the [K, M] rulebook, gout once and the small dW.
// From Cin 32 on fp32 operations bound it; chip_smoke.py reports the bound
// and its kind per shape.
//
// Design (simple first): a 256-thread block owns one tap k, one chunk of
// CI = 16, 32 or 64 input channels (by Cin) and one contiguous range of
// output rows, which it walks in tiles of 32 rows. Per tile it loads the 32
// partner indices, skips the tile when every one is a miss (as the forward
// kernel does), stages the 32 gathered feature rows (its channel chunk) and
// the 32 gout rows in shared memory as fp32, and accumulates a
// [CI, Cout <= 128] product in registers: thread (ty, tx) holds channels
// ty + 8*i and columns tx + 32*j. A warp reads one feature value
// (broadcast) and consecutive gout columns, so shared memory is
// conflict-free.
//
// The reduction over row ranges: every block writes its partial product to
// its own slot of part[nsplit, K, Cin, Cout], and a second kernel,
// dw_reduce, sums the slots in slot order. No atomics: every sum runs in a
// fixed order, so two runs on the same inputs give bit-identical dW. With
// nsplit == 1 the block writes dW directly and no reduction is launched.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileM = 32;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// NC: column groups of 32 (Cout <= 32 * NC); R: channels per thread
// (CI = 8 * R channels per block).
template <typename T, int NC, int R>
__global__ void __launch_bounds__(kThreads)
dw_kernel(const T* __restrict__ feat, const int* __restrict__ rb,
          const T* __restrict__ gout, float* __restrict__ part, int K, int M,
          int Cin, int Cout, int miss, int tiles_per_split) {
  constexpr int CI = 8 * R;
  __shared__ int s_idx[kTileM];
  __shared__ float s_x[kTileM][CI];
  __shared__ float s_g[kTileM][NC * 32];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int split = blockIdx.x, c0 = blockIdx.y * CI, k = blockIdx.z;
  float acc[R][NC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;

  const long long tile0 = (long long)split * tiles_per_split;
  for (int t = 0; t < tiles_per_split; ++t) {
    const long long m0 = (tile0 + t) * kTileM;
    if (m0 >= M) break;  // the same for every thread of the block
    int hit = 0;
    if (threadIdx.x < kTileM) {
      const long long m = m0 + threadIdx.x;
      int idx = m < M ? rb[(long long)k * M + m] : miss;
      if (idx < 0 || idx > miss) idx = miss;  // never read out of bounds
      s_idx[threadIdx.x] = idx;
      hit = idx != miss;
    }
    if (!__syncthreads_or(hit)) continue;  // no partner in this tile

    for (int e = threadIdx.x; e < kTileM * CI; e += kThreads) {
      const int r = e / CI, c = e % CI;
      s_x[r][c] = c0 + c < Cin
          ? to_f32(feat[(long long)s_idx[r] * Cin + c0 + c]) : 0.f;
    }
    for (int e = threadIdx.x; e < kTileM * NC * 32; e += kThreads) {
      const int r = e / (NC * 32), o = e % (NC * 32);
      const long long m = m0 + r;
      s_g[r][o] = (m < M && o < Cout) ? to_f32(gout[m * Cout + o]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < kTileM; ++r) {
      float gv[NC];
#pragma unroll
      for (int j = 0; j < NC; ++j) gv[j] = s_g[r][tx + 32 * j];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float xv = s_x[r][ty + 8 * i];
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(xv, gv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  float* dst = part + ((long long)split * K + k) * Cin * Cout;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int ci = c0 + ty + 8 * i;
    if (ci >= Cin) continue;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int o = tx + 32 * j;
      if (o < Cout) dst[(long long)ci * Cout + o] = acc[i][j];
    }
  }
}

// dw[i] = sum over slots s of part[s, i], in slot order.
__global__ void __launch_bounds__(kThreads)
dw_reduce(const float* __restrict__ part, float* __restrict__ dw, int n,
          int nsplit) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float acc = 0.f;
  for (int s = 0; s < nsplit; ++s) acc += part[(long long)s * n + i];
  dw[i] = acc;
}

template <typename T, int NC, int R>
void launch_r(const T* f, const int* r, const T* g, float* part, int K, int M,
              int Cin, int Cout, int miss, int nsplit, cudaStream_t st) {
  const int tiles = (M + kTileM - 1) / kTileM;
  const int tiles_per_split = (tiles + nsplit - 1) / nsplit;
  const dim3 grid((unsigned)nsplit, (unsigned)((Cin + 8 * R - 1) / (8 * R)),
                  (unsigned)K);
  dw_kernel<T, NC, R><<<grid, kThreads, 0, st>>>(f, r, g, part, K, M, Cin,
                                                 Cout, miss, tiles_per_split);
}

template <typename T, int NC>
void launch_nc(const T* f, const int* r, const T* g, float* part, int K,
               int M, int Cin, int Cout, int miss, int nsplit,
               cudaStream_t st) {
  if (Cin <= 16)
    launch_r<T, NC, 2>(f, r, g, part, K, M, Cin, Cout, miss, nsplit, st);
  else if (Cin <= 32)
    launch_r<T, NC, 4>(f, r, g, part, K, M, Cin, Cout, miss, nsplit, st);
  else
    launch_r<T, NC, 8>(f, r, g, part, K, M, Cin, Cout, miss, nsplit, st);
}

template <typename T>
int launch(const void* feat, const void* rb, const void* gout, float* part,
           int K, int M, int Cin, int Cout, int miss, int nsplit,
           cudaStream_t st) {
  const T* f = static_cast<const T*>(feat);
  const int* r = static_cast<const int*>(rb);
  const T* g = static_cast<const T*>(gout);
  switch ((Cout + 31) / 32) {
    case 1: launch_nc<T, 1>(f, r, g, part, K, M, Cin, Cout, miss, nsplit, st); break;
    case 2: launch_nc<T, 2>(f, r, g, part, K, M, Cin, Cout, miss, nsplit, st); break;
    case 3: launch_nc<T, 3>(f, r, g, part, K, M, Cin, Cout, miss, nsplit, st); break;
    case 4: launch_nc<T, 4>(f, r, g, part, K, M, Cin, Cout, miss, nsplit, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// feat [miss + 1, Cin] and gout [M, Cout] fp32 (bf16 = 0) or bf16
// (bf16 = 1), rb [K, M] int32, part [nsplit, K, Cin, Cout] fp32 scratch
// (part == dw when nsplit == 1), dw [K, Cin, Cout] fp32; 1 <= Cout <= 128,
// K <= 65535.
extern "C" int rulebook_conv_dw(const void* feat, const void* rb,
                                const void* gout, void* part, void* dw, int K,
                                int M, int Cin, int Cout, int miss,
                                int nsplit, int bf16, void* stream) {
  if (M <= 0 || K <= 0 || K > 65535 || Cin <= 0 || Cout <= 0 || Cout > 128 ||
      nsplit <= 0 || (nsplit == 1 && part != dw))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  const int err =
      bf16 ? launch<__nv_bfloat16>(feat, rb, gout, p, K, M, Cin, Cout, miss,
                                   nsplit, st)
           : launch<float>(feat, rb, gout, p, K, M, Cin, Cout, miss, nsplit,
                           st);
  if (err != 0 || nsplit == 1) return err;
  const long long n = (long long)K * Cin * Cout;
  if (n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dw_reduce<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      p, static_cast<float*>(dw), (int)n, nsplit);
  return (int)cudaGetLastError();
}
