// Fused gather -> GEMM rulebook sparse convolution (forward) for Hopper
// (sm_90a).
//
// Computes out[m, :] = sum_k feat[rb[k, m], :] @ w[k] for
//   feat [N + 1, Cin]  flat voxel features, last row all zeros,
//   rb   [K, M] int32  global flat partner rows, a miss is N (the zero row),
//   w    [K, Cin, Cout],
//   out  [M, Cout],
// in fp32 or bf16 with fp32 accumulation. This is the contract of
// _gather_gemm_core (lidarseg3d_tpu/ops/sparse.py) at the JAX layout.
//
// Replaces: lidarseg3d_tpu/ops/pallas_conv.py::_conv_kernel (through
// rulebook_conv_block as wired by ops/sparse_pallas.py::fused_conv). The TPU
// kernel kept the whole feature table transposed in VMEM and gathered with
// 128-lane in-register windows; that layout and its window metadata
// (build_kernel_meta) and Cin chunking exist for VMEM and do not carry over.
//
// What bounds it on the H100 depends on the width. Per (output row,
// partner) pair the useful work is 2*Cin*Cout flops; the bytes are the
// distinct partner rows (Cin each), the [K, M] int32 rulebook and the
// [M, Cout] output. In fp32 only the input conv (Cin 12 -> 32) is bound
// by those bytes, the rulebook and the output weighing most; from Cin 32
// on, fp32 operations bound it. chip_smoke.py reports the bound and its
// kind per shape. The partner rows are random gathers whose lines L2
// (50 MB) mostly holds.
//
// Design (simple first): one 256-thread block per tile of 64 output rows
// and a group of up to 128 output columns (blockIdx.y picks the group, so
// one launch serves any Cout: as dX under the transposed rulebook the
// output width is the conv's Cin, up to 256 on the decoder's concat
// convs). For each tap it loads the tile's 64
// partner indices, skips the tap when every one is a miss, then walks Cin
// in chunks of 32: the 64 partner rows and that tap's W[k] slice are staged
// in shared memory as fp32, and each thread accumulates an 8-row x
// ceil(Cout/32)-column micro-tile in registers. Warps read the same row
// (broadcast) and consecutive columns, so shared memory is conflict-free.
// Misses gather the zero row; the tap skip drops tiles with no partner.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileM = 64;
constexpr int kChunk = 32;
constexpr int kThreads = 256;
constexpr int kRowsPerThread = kTileM / (kThreads / 32);  // 8

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// WIDE: Cout > 128, blockIdx.y picks the group of 128 columns; otherwise
// the column offset is the constant 0.
template <typename T, int NC, bool WIDE = false>
__global__ void __launch_bounds__(kThreads)
conv_kernel(const T* __restrict__ feat, const int* __restrict__ rb,
            const T* __restrict__ w, T* __restrict__ out, int K, int M,
            int Cin, int Cout, int miss) {
  __shared__ int s_idx[kTileM];
  __shared__ float s_x[kTileM][kChunk];
  __shared__ float s_w[kChunk][NC * 32];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int m0 = blockIdx.x * kTileM;
  const int o0 = WIDE ? blockIdx.y * NC * 32 : 0;  // the group's first column
  float acc[kRowsPerThread][NC];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[r][j] = 0.f;

  for (int k = 0; k < K; ++k) {
    int hit = 0;
    if (threadIdx.x < kTileM) {
      const int m = m0 + threadIdx.x;
      int idx = m < M ? rb[(long long)k * M + m] : miss;
      if (idx < 0 || idx > miss) idx = miss;  // never read out of bounds
      s_idx[threadIdx.x] = idx;
      hit = idx != miss;
    }
    if (!__syncthreads_or(hit)) continue;  // no partner in this tile

    for (int c0 = 0; c0 < Cin; c0 += kChunk) {
      for (int e = threadIdx.x; e < kTileM * kChunk; e += kThreads) {
        const int r = e / kChunk, c = e % kChunk;
        s_x[r][c] = c0 + c < Cin
            ? to_f32(feat[(long long)s_idx[r] * Cin + c0 + c]) : 0.f;
      }
      for (int e = threadIdx.x; e < kChunk * NC * 32; e += kThreads) {
        const int c = e / (NC * 32), o = e % (NC * 32);
        s_w[c][o] = (c0 + c < Cin && o0 + o < Cout)
            ? to_f32(w[((long long)k * Cin + c0 + c) * Cout + o0 + o]) : 0.f;
      }
      __syncthreads();
      const int cn = min(kChunk, Cin - c0);
      for (int c = 0; c < cn; ++c) {
        float wv[NC];
#pragma unroll
        for (int j = 0; j < NC; ++j) wv[j] = s_w[c][tx + 32 * j];
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r) {
          const float xv = s_x[ty + 8 * r][c];
#pragma unroll
          for (int j = 0; j < NC; ++j) acc[r][j] = fmaf(xv, wv[j], acc[r][j]);
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int m = m0 + ty + 8 * r;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int o = o0 + tx + 32 * j;
      if (o < Cout) out[(long long)m * Cout + o] = from_f32<T>(acc[r][j]);
    }
  }
}

template <typename T>
int launch(const void* feat, const void* rb, const void* w, void* out, int K,
           int M, int Cin, int Cout, int miss, cudaStream_t st) {
  const dim3 grid((unsigned)((M + kTileM - 1) / kTileM),
                  (unsigned)((Cout + 127) / 128));
  const T* f = static_cast<const T*>(feat);
  const int* r = static_cast<const int*>(rb);
  const T* wt = static_cast<const T*>(w);
  T* o = static_cast<T*>(out);
  if (Cout > 128) {  // groups of 128 columns, the last one masked
    conv_kernel<T, 4, true><<<grid, kThreads, 0, st>>>(f, r, wt, o, K, M, Cin, Cout, miss);
    return (int)cudaGetLastError();
  }
  switch ((Cout + 31) / 32) {
    case 1: conv_kernel<T, 1><<<grid, kThreads, 0, st>>>(f, r, wt, o, K, M, Cin, Cout, miss); break;
    case 2: conv_kernel<T, 2><<<grid, kThreads, 0, st>>>(f, r, wt, o, K, M, Cin, Cout, miss); break;
    case 3: conv_kernel<T, 3><<<grid, kThreads, 0, st>>>(f, r, wt, o, K, M, Cin, Cout, miss); break;
    case 4: conv_kernel<T, 4><<<grid, kThreads, 0, st>>>(f, r, wt, o, K, M, Cin, Cout, miss); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// feat [miss + 1, Cin], rb [K, M] int32, w [K, Cin, Cout], out [M, Cout];
// feat/w/out fp32 (bf16 = 0) or bf16 (bf16 = 1); 1 <= Cout <= 1024.
extern "C" int rulebook_conv(const void* feat, const void* rb, const void* w,
                             void* out, int K, int M, int Cin, int Cout,
                             int miss, int bf16, void* stream) {
  if (M <= 0 || K <= 0 || Cin <= 0 || Cout <= 0 || Cout > 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(feat, rb, w, out, K, M, Cin, Cout, miss, st)
              : launch<float>(feat, rb, w, out, K, M, Cin, Cout, miss, st);
}
