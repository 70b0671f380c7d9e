// Weight gradient of the rulebook sparse convolution on Hopper's tensor
// cores (sm_90a).
//
// Computes dW[k, ci, co] = sum_m feat[rb[k, m], ci] * gout[m, co] for
//   feat [N + 1, Cin]  flat voxel features; an index outside [0, miss) is a
//                      miss and contributes nothing (it is never read),
//   rb   [K, M] int32  partner rows,
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
// here.
//
// What bounds it on the H100: per (output row, partner) pair the work is
// 2*Cin*Cout flops, as in the forward; the bytes are the distinct partner
// rows, the [K, M] rulebook, gout once and dW. On tensor cores the narrow
// products are bound by those bytes. fp32 runs as 3xTF32 (tensor_core.cuh).
//
// Design. dW_k = X_k^T G over the rows, with X_k the gathered rows of tap
// k: an MMA whose depth is the rows. A 128-thread block (4 warps tiling
// [CIT, COT]) owns one range of output rows, one group of taps
// and one [CIT, COT] tile of (Cin, Cout): as many taps as fit its
// accumulator registers and leave room for four blocks an SM (7 taps at
// 16 x 32, 4 at 32 x 32 and 32 x 64, 2 at 64 x 64; Cin and Cout wider than
// the tile are tiled over blockIdx.z). Its rows are the 32-row tiles s,
// s + nsplit, s + 2 nsplit, ... of row range s = blockIdx.x, so that the
// padding rows at the end of each sample's capacity fall on every range
// alike. A pre-pass reads the indices of up to 256 of those tiles at once
// and lists the ones with a partner at any tap of the group: a tile with
// none costs nothing more (the deep stages' capacity is mostly padding:
// at stage 4 about 2,800 of 19,660 rows a sample are active). The block
// walks its listed tiles double buffered: while the warps run tile i's
// MMAs, cp.async has in flight the
// gathered rows [32, CIT] of every tap of tile i + 1 with a partner in it
// (a miss is a zero-fill that reads nothing), tile i + 1's gout rows
// [32, COT], staged once for all the group's taps, and tile i + 2's partner
// indices. One warp ballot per tap gives the tile's rows with a partner
// there; a tap with none is neither gathered nor multiplied, and a k-step
// of 8 (fp32) or 16 (bf16) rows with none is skipped. The products are mma.sync (ldmatrix.trans fragments;
// bf16 m16n8k16, or fp32 split into 3xTF32 m16n8k8). Each (tile, tap)
// accumulates into zeroed registers that are then added to the tap's sum
// in fp32: the tensor cores' accumulation truncates, and carried over
// thousands of rows it lost fp32 accuracy (up to 1e-4 of max|dW| on the
// card).
//
// The reduction over row ranges: every block sums its tiles in ascending
// order and writes its partial product to
// its own slot of part[nsplit, K, Cin, Cout], and a second kernel,
// dw_reduce, sums the slots in slot order. No atomics: every sum runs in a
// fixed order, so two runs on the same inputs give bit-identical dW. With
// nsplit == 1 the block writes dW directly and no reduction is launched.

#include "tensor_core.cuh"

namespace {

using namespace tc;

constexpr int kThreads = 128;
constexpr int kTileM = 32;  // rows per tile: the MMA depth of two bf16 k16
constexpr int kChunk = 256;  // tiles one pre-pass lists

template <typename T, int CIT, int COT, int TG>
struct DwTile {
  static constexpr int ES = sizeof(T);
  static constexpr int WM = CIT == 16 ? 1 : 2, WN = 4 / WM;  // warp grid
  static constexpr int MT = CIT / (16 * WM), NT = COT / (8 * WN);
  // row pads that keep ldmatrix and the scalar fragment loads free of bank
  // conflicts and every row 16-byte aligned
  static constexpr int LDX = CIT + 8, LDG = COT + 8;
  static constexpr int X_TAP = kTileM * LDX;  // one tap's gathered rows
  // one tile's buffer: X for TG taps, then the tile's gout rows
  static constexpr int BUF = TG * X_TAP + kTileM * LDG;
  static constexpr int SMEM = 2 * BUF * ES + 2 * TG * kTileM * 4;
};

template <typename T, int CIT, int COT, int TG>
__global__ void __launch_bounds__(kThreads)
dw_kernel(const T* __restrict__ feat, const int* __restrict__ rb,
          const T* __restrict__ gout, float* __restrict__ part, int K, int M,
          int Cin, int Cout, int miss, int taps_per_group, int ci_tiles,
          int vec_x, int vec_g) {
  using D = DwTile<T, CIT, COT, TG>;
  constexpr int ES = D::ES, MT = D::MT, NT = D::NT;
  constexpr int KSTEP = ES == 2 ? 16 : 8;  // the MMA's depth
  extern __shared__ __align__(128) unsigned char smem[];
  T* bufs = reinterpret_cast<T*>(smem);  // [2][BUF]
  int* s_idx = reinterpret_cast<int*>(smem + 2 * D::BUF * ES);  // [2][TG][32]
  __shared__ unsigned s_bits[kChunk / 32];
  __shared__ int s_list[kChunk];  // the chunk's tiles with work, ascending
  __shared__ int s_n;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / D::WN, wn = warp % D::WN;
  const int k0 = blockIdx.y * taps_per_group;
  const int nk = min(K - k0, taps_per_group);
  const int ci0 = (blockIdx.z % ci_tiles) * CIT, co0 = (blockIdx.z / ci_tiles) * COT;
  const long long tiles = ((long long)M + kTileM - 1) / kTileM;
  const long long nsplit = gridDim.x;
  // this range's tiles: blockIdx.x + u * nsplit for u < nb
  const long long nb =
      tiles > blockIdx.x ? (tiles - 1 - blockIdx.x) / nsplit + 1 : 0;

  const int ex = vec_x / ES, shx = __ffs(CIT / ex) - 1;
  const int eg = vec_g / ES, shg = __ffs(COT / eg) - 1;

  // the partner rows of tile i (of the range) for every tap of the group,
  // into index slot i & 1
  auto load_idx = [&](int i) {
    const long long m0 = (long long)s_list[i] * kTileM;
    int* dst = s_idx + (i & 1) * TG * kTileM;
    for (int e = threadIdx.x; e < nk * kTileM; e += kThreads) {
      const int j = e / kTileM, r = e % kTileM;
      const long long m = m0 + r;
      cp_async<4>(smem_addr(dst + j * kTileM + r),
                  m < M ? rb + (long long)(k0 + j) * M + m : rb, m < M);
    }
  };
  // the rows of tile i with a partner at each tap of the group (one bit a
  // row; every warp computes the same masks from shared memory), and the
  // taps with any
  auto tile_rows = [&](int i, unsigned (&rows)[TG]) {
    const long long m = (long long)s_list[i] * kTileM + lane;
    const int* idx = s_idx + (i & 1) * TG * kTileM;
    unsigned mask = 0;
#pragma unroll
    for (int j = 0; j < TG; ++j) {
      rows[j] = j < nk ? __ballot_sync(0xffffffffu,
                                       m < M && (unsigned)idx[j * kTileM + lane]
                                                    < (unsigned)miss)
                       : 0u;
      if (rows[j]) mask |= 1u << j;
    }
    return mask;
  };
  // gathers of tile i's rows for its active taps, and its gout rows, into
  // buffer i & 1
  auto load_tile = [&](int i, unsigned mask) {
    const long long m0 = (long long)s_list[i] * kTileM;
    T* buf = bufs + (i & 1) * D::BUF;
    const int* idx = s_idx + (i & 1) * TG * kTileM;
#pragma unroll
    for (int j = 0; j < TG; ++j) {
      if (!(mask >> j & 1)) continue;
      for (int e = threadIdx.x; e < (kTileM << shx); e += kThreads) {
        const int r = e >> shx, cc = (e & ((1 << shx) - 1)) * ex;
        const int row = idx[j * kTileM + r], c = ci0 + cc;
        const bool ok = m0 + r < M && (unsigned)row < (unsigned)miss && c < Cin;
        cp_async_vec(smem_addr(buf + j * D::X_TAP + r * D::LDX + cc),
                     ok ? feat + (long long)row * Cin + c : feat, ok, vec_x);
      }
    }
    T* gs = buf + TG * D::X_TAP;
    for (int e = threadIdx.x; e < (kTileM << shg); e += kThreads) {
      const int r = e >> shg, nn = (e & ((1 << shg) - 1)) * eg;
      const long long m = m0 + r;
      const int n = co0 + nn;
      const bool ok = m < M && n < Cout;
      cp_async_vec(smem_addr(gs + r * D::LDG + nn),
                   ok ? gout + m * Cout + n : gout, ok, vec_g);
    }
  };

  float acc[TG][MT][NT][4];
#pragma unroll
  for (int j = 0; j < TG; ++j)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[j][i][n][q] = 0.f;

  // acc[j] += X_j^T G over the tile's 32 rows for every active tap j, with
  // fragments of A = X_j^T ([CIT, 32]) and B = G ([32, COT]) from the
  // row-major tiles. The tensor cores' accumulation truncates, and over
  // thousands of rows it cost fp32 accuracy, so no MMA chain runs on acc:
  // bf16 chains a (tile, tap)'s two MMAs on zeroed registers and adds them
  // to acc in fp32; fp32 adds each hi*hi MMA to acc in fp32 and chains the
  // cross products of the (tile, tap) on zeroed registers
  // (tensor_core.cuh mma_3xtf32).
  // (a k-step of 8 or 16 rows with no partner at the tap is skipped)
  auto compute = [&](int i, const unsigned (&rows)[TG]) {
    const T* buf = bufs + (i & 1) * D::BUF;
    const T* gs = buf + TG * D::X_TAP;
#pragma unroll
    for (int j = 0; j < TG; ++j) {
      if (!rows[j]) continue;
      const T* xs = buf + j * D::X_TAP;
      float tmp[MT][NT][4];
#pragma unroll
      for (int a = 0; a < MT; ++a)
#pragma unroll
        for (int b = 0; b < NT; ++b)
#pragma unroll
          for (int q = 0; q < 4; ++q) tmp[a][b][q] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kTileM; kk += KSTEP) {
        if (!((rows[j] >> kk) & ((1u << KSTEP) - 1u))) continue;
        if constexpr (ES == 2) {
          uint32_t a[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            ldsm_x4_t(a[mt], smem_addr(xs + (kk + (lane & 7) + ((lane >> 4) << 3))
                                       * D::LDX + (wm * MT + mt) * 16
                                       + (((lane >> 3) & 1) << 3)));
#pragma unroll
          for (int np = 0; np < NT; np += 2) {
            const int nb = (wn * NT + np) * 8;
            const uint32_t addr = smem_addr(
                gs + (kk + (lane & 7) + (((lane >> 3) & 1) << 3)) * D::LDG + nb
                + ((lane >> 4) << 3));
            if constexpr (NT == 1) {
              uint32_t b[2];
              ldsm_x2_t(b, addr);
#pragma unroll
              for (int mt = 0; mt < MT; ++mt)
                mma_bf16(tmp[mt][np], a[mt], b[0], b[1]);
            } else {
              uint32_t b[4];
              ldsm_x4_t(b, addr);
#pragma unroll
              for (int mt = 0; mt < MT; ++mt) {
                mma_bf16(tmp[mt][np], a[mt], b[0], b[1]);
                mma_bf16(tmp[mt][np + 1], a[mt], b[2], b[3]);
              }
            }
          }
        } else {
          uint32_t ahi[MT][4], alo[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const int cb = (wm * MT + mt) * 16 + g;
            const float v[4] = {xs[(kk + t) * D::LDX + cb],
                                xs[(kk + t) * D::LDX + cb + 8],
                                xs[(kk + t + 4) * D::LDX + cb],
                                xs[(kk + t + 4) * D::LDX + cb + 8]};
#pragma unroll
            for (int q = 0; q < 4; ++q) split_tf32(v[q], ahi[mt][q], alo[mt][q]);
          }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int nb = (wn * NT + nt) * 8 + g;
            uint32_t bh0, bl0, bh1, bl1;
            split_tf32(gs[(kk + t) * D::LDG + nb], bh0, bl0);
            split_tf32(gs[(kk + t + 4) * D::LDG + nb], bh1, bl1);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
              mma_3xtf32(acc[j][mt][nt], tmp[mt][nt], ahi[mt], alo[mt], bh0,
                         bh1, bl0, bl1);
          }
        }
      }
#pragma unroll
      for (int a = 0; a < MT; ++a)
#pragma unroll
        for (int b = 0; b < NT; ++b)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[j][a][b][q] += tmp[a][b][q];
    }
  };

  // The range in chunks of kChunk tiles: list the chunk's tiles with a
  // partner at any tap of the group (each warp reads four tiles' indices
  // at once), then walk the list double buffered: while tile i's MMAs run,
  // the gathers and gout rows of tile i + 1 and the partner indices of
  // tile i + 2 are in flight (one cp.async group per tile).
  unsigned rows[TG], next[TG];
  for (long long c0 = 0; c0 < nb; c0 += kChunk) {
    const int cn = (int)min((long long)kChunk, nb - c0);
    if (threadIdx.x < kChunk / 32) s_bits[threadIdx.x] = 0u;
    __syncthreads();
    for (int u0 = warp * 4; u0 < cn; u0 += kThreads / 32 * 4) {
      bool hit[4] = {false, false, false, false};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const long long m = (blockIdx.x + (c0 + u0 + q) * nsplit) * kTileM + lane;
        if (u0 + q < cn && m < M) {
#pragma unroll
          for (int j = 0; j < TG; ++j)
            if (j < nk)
              hit[q] |= (unsigned)__ldg(rb + (long long)(k0 + j) * M + m)
                        < (unsigned)miss;
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (__any_sync(0xffffffffu, hit[q]) && lane == 0)
          atomicOr(&s_bits[(u0 + q) >> 5], 1u << ((u0 + q) & 31));
    }
    __syncthreads();
    if (warp == 0) {  // the listed tiles in ascending order
      const unsigned bits = lane < kChunk / 32 ? s_bits[lane] : 0u;
      int pos = __popc(bits);
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, pos, d);
        if (lane >= d) pos += v;
      }
      if (lane == 31) s_n = pos;
      pos -= __popc(bits);
      for (unsigned b = bits; b; b &= b - 1)
        s_list[pos++] =
            (int)(blockIdx.x + (c0 + lane * 32 + __ffs(b) - 1) * nsplit);
    }
    __syncthreads();
    const int ntiles = s_n;
#pragma unroll
    for (int j = 0; j < TG; ++j) rows[j] = next[j] = 0u;
    if (ntiles > 0) {
      load_idx(0);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      const unsigned mask = tile_rows(0, rows);
      if (mask) load_tile(0, mask);
      if (ntiles > 1) load_idx(1);
      cp_async_commit();
    }
    for (int i = 0; i < ntiles; ++i) {
      cp_async_wait<0>();
      __syncthreads();  // tile i and the indices of tile i + 1 landed;
                        // every warp is done with tile i - 1's buffer
      if (i + 1 < ntiles) {
        const unsigned mask = tile_rows(i + 1, next);
        if (mask) load_tile(i + 1, mask);
        if (i + 2 < ntiles) load_idx(i + 2);
      }
      cp_async_commit();
      compute(i, rows);
#pragma unroll
      for (int j = 0; j < TG; ++j) rows[j] = next[j];
    }
    __syncthreads();  // every warp is done with the list and the buffers
  }

  float* dst = part + (long long)blockIdx.x * K * Cin * Cout;
#pragma unroll
  for (int jj = 0; jj < TG; ++jj) {
    if (jj >= nk) break;
    float* dk = dst + (long long)(k0 + jj) * Cin * Cout;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ci = ci0 + (wm * MT + mt) * 16 + g + 8 * h;
        if (ci >= Cin) continue;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int co = co0 + (wn * NT + nt) * 8 + 2 * t;
          if (co < Cout) dk[(long long)ci * Cout + co] = acc[jj][mt][nt][2 * h];
          if (co + 1 < Cout)
            dk[(long long)ci * Cout + co + 1] = acc[jj][mt][nt][2 * h + 1];
        }
      }
  }
}

// dw[i] = sum over slots s of part[s, i], in slot order.
__global__ void __launch_bounds__(256)
dw_reduce(const float* __restrict__ part, float* __restrict__ dw, int n,
          int nsplit) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  float acc = 0.f;
  for (int s = 0; s < nsplit; ++s) acc += part[(long long)s * n + i];
  dw[i] = acc;
}

template <typename T, int CIT, int COT, int TG>
int launch_tile(const void* feat, const int* rb, const void* gout,
                float* part, int K, int M, int Cin, int Cout, int miss,
                int nsplit, int vec_x, int vec_g, cudaStream_t st) {
  using D = DwTile<T, CIT, COT, TG>;
  auto kern = dw_kernel<T, CIT, COT, TG>;
  static bool sized = false;  // dynamic shared memory above 48 KB, once
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, D::SMEM);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const int groups = (K + TG - 1) / TG;
  const int tpg = (K + groups - 1) / groups;  // taps per group, balanced
  const int ci_tiles = (Cin + CIT - 1) / CIT, co_tiles = (Cout + COT - 1) / COT;
  const dim3 grid((unsigned)nsplit, (unsigned)((K + tpg - 1) / tpg),
                  (unsigned)(ci_tiles * co_tiles));
  kern<<<grid, kThreads, D::SMEM, st>>>(
      static_cast<const T*>(feat), rb, static_cast<const T*>(gout), part, K,
      M, Cin, Cout, miss, tpg, ci_tiles, vec_x, vec_g);
  return (int)cudaGetLastError();
}

// The tile by width (ops/rulebook_conv.py dw_tiling mirrors it): CIT x COT
// and the taps a block holds.
template <typename T>
int launch(const void* feat, const int* rb, const void* gout, float* part,
           int K, int M, int Cin, int Cout, int miss, int nsplit, int vec_x,
           int vec_g, cudaStream_t st) {
  if (Cin <= 16)
    return launch_tile<T, 16, 32, 7>(feat, rb, gout, part, K, M, Cin, Cout,
                                      miss, nsplit, vec_x, vec_g, st);
  if (Cout <= 32)
    return launch_tile<T, 32, 32, 4>(feat, rb, gout, part, K, M, Cin, Cout,
                                     miss, nsplit, vec_x, vec_g, st);
  if (Cin <= 32)
    return launch_tile<T, 32, 64, 4>(feat, rb, gout, part, K, M, Cin, Cout,
                                     miss, nsplit, vec_x, vec_g, st);
  return launch_tile<T, 64, 64, 2>(feat, rb, gout, part, K, M, Cin, Cout,
                                   miss, nsplit, vec_x, vec_g, st);
}

}  // namespace

// feat [miss + 1, Cin] and gout [M, Cout] fp32 (bf16 = 0) or bf16
// (bf16 = 1), rb [K, M] int32, part [nsplit, K, Cin, Cout] fp32 scratch
// (part == dw when nsplit == 1), dw [K, Cin, Cout] fp32. Rows are copied in
// 16, 8 or 4 bytes, as the widths and the alignment of feat and gout
// allow: Cin and Cout times the element size must be multiples of 4 bytes
// and feat, gout 4-byte aligned.
extern "C" int rulebook_conv_dw(const void* feat, const void* rb,
                                const void* gout, void* part, void* dw, int K,
                                int M, int Cin, int Cout, int miss,
                                int nsplit, int bf16, void* stream) {
  const int es = bf16 ? 2 : 4;
  const int vec_x = copy_width((long long)Cin * es, feat);
  const int vec_g = copy_width((long long)Cout * es, gout);
  if (M <= 0 || K <= 0 || K > 65535 || Cin <= 0 || Cout <= 0 ||
      nsplit <= 0 || (nsplit == 1 && part != dw) || vec_x == 0 ||
      vec_g == 0 || (long long)((Cin + 15) / 16) * ((Cout + 31) / 32) > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  const int* r = static_cast<const int*>(rb);
  const int err =
      bf16 ? launch<__nv_bfloat16>(feat, r, gout, p, K, M, Cin, Cout, miss,
                                   nsplit, vec_x, vec_g, st)
           : launch<float>(feat, r, gout, p, K, M, Cin, Cout, miss, nsplit,
                           vec_x, vec_g, st);
  if (err != 0 || nsplit == 1) return err;
  const long long n = (long long)K * Cin * Cout;
  if (n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dw_reduce<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      p, static_cast<float*>(dw), (int)n, nsplit);
  return (int)cudaGetLastError();
}
