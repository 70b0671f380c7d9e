// Fused gather -> GEMM rulebook sparse convolution (forward, and dX under
// the transposed rulebook) on Hopper's tensor cores (sm_90a).
//
// Computes out[m, :] = sum_k feat[rb[k', m], :] @ W_k for
//   feat [rows, Cin]   feature rows; an index outside [0, miss) is a miss
//                      and contributes zeros without being read,
//   rb   [K, M] int32  partner rows; k' = K-1-k when flip_taps (the taps of
//                      a submanifold rulebook mirrored: its transpose),
//   w    [K, Cin, Cout] (W_k = w[k]), or [K, Cout, Cin] when w_t
//                      (W_k = w[k]^T: the forward weights, read as dX needs),
//   out  [Mout, Cout]  Mout = M, or M + 1 with a last row of zeros (the
//                      zero row of the flat feature table dX writes into),
// in fp32 or bf16 with fp32 accumulation. With flip_taps, w_t, miss = the
// cotangent's row count and Mout = M + 1 it is the data gradient of the
// forward, with no copy of the rulebook, the weights or the cotangent.
// The contract of _gather_gemm_core (lidarseg3d_tpu/ops/sparse.py).
//
// Replaces: lidarseg3d_tpu/ops/pallas_conv.py::_conv_kernel (through
// rulebook_conv_block as wired by ops/sparse_pallas.py::fused_conv). The TPU
// kernel kept the whole feature table transposed in VMEM and gathered with
// 128-lane in-register windows; that layout and its window metadata exist
// for VMEM and do not carry over.
//
// What bounds it on the H100: per (output row, partner) pair the work is
// 2*Cin*Cout flops; the bytes are the distinct partner rows, the [K, M]
// rulebook and the output. On tensor cores the narrow convs (Cin <= 64) are
// bound by those bytes; the products bound the wide ones. fp32 runs as
// 3xTF32 (tensor_core.cuh): three TF32 products per product, so its least
// time is 3 * flops / 495 TFLOP/s; bf16 runs at 989 TFLOP/s.
// chip_smoke.py reports the bound and its kind per shape.
//
// Design. A 128-thread block (2 x 2 warps) owns a tile of 64 output rows,
// a group of BN = 32 or 64 output columns (blockIdx.y) and a group of
// taps (blockIdx.z). It loads the tile's partner indices for all its taps
// once (one warp ballot per 32 rows gives each tap's hit mask) and keeps
// only the taps with a partner in the tile. Then it walks (tap, chunk of BK
// input channels) steps through a ring of shared-memory stages (four, or
// three at BN = 64): cp.async gathers the 64 partner rows (a miss is a
// zero-fill that reads nothing) and W_k's [BK, BN] slice for the steps
// ahead while the warps run step s's mma.sync products (ldmatrix
// fragments; bf16 m16n8k16, or fp32 split into 3xTF32 m16n8k8); a warp
// skips its 16-row MMA tiles with no partner at the step's tap. The
// tensor cores' own accumulation truncates, so no long chain of MMAs
// builds the tile's sum: a bf16 step's products, and each fp32 hi*hi
// product, are added to it in fp32 (tensor_core.cuh). BK is 16 for
// Cin <= 16 (the input conv's 12 channels pad to the bf16 MMA's depth, not
// to 32) and 32 otherwise.
//
// Filling the card: the deep stages have few active rows (at stage 4 about
// 2,800 of 19,660 a sample) and a long reduction (27 taps x Cin 256), so
// wide inputs split the taps over blockIdx.z (Cin / 64 groups). Each group
// writes fp32 partials for its tile, with a flag saying whether the tile
// had work, and conv_reduce sums the groups in group order: no atomics, so
// two runs on the same inputs give the same bits.

#include "tensor_core.cuh"

namespace {

using namespace tc;

constexpr int kThreads = 128;
constexpr int kTileM = 64;
constexpr int kMaxTaps = 32;  // taps one block holds indices for

template <typename T, int BN, int BK, bool WT>
struct ConvTile {
  static constexpr int ES = sizeof(T);
  // the ring's depth: three at BN = 64 leave room for three blocks an SM
  static constexpr int STAGES = BN >= 64 ? 3 : 4;
  // row pads that keep ldmatrix and the scalar fragment loads free of bank
  // conflicts and every row 16-byte aligned
  static constexpr int PAD_K = ES == 4 ? 4 : 8;
  static constexpr int LDA = BK + PAD_K;                // A [64][LDA]
  static constexpr int LDB = WT ? BK + PAD_K : BN + 8;  // B [BN][LDB] / [BK][LDB]
  static constexpr int A_ELEMS = kTileM * LDA;
  static constexpr int B_ELEMS = (WT ? BN : BK) * LDB;
  static constexpr int STAGE_BYTES = (A_ELEMS + B_ELEMS) * ES;
  static constexpr int MAX_SMEM = STAGES * STAGE_BYTES + kMaxTaps * kTileM * 4;
};

template <typename T>
__device__ __forceinline__ void store_pair(T* row, int c, int Cout, float a,
                                           float b) {
  if (c < Cout) row[c] = from_f32<T>(a);
  if (c + 1 < Cout) row[c + 1] = from_f32<T>(b);
}

template <typename T, int BN, int BK, bool WT>
__global__ void __launch_bounds__(kThreads)
conv_kernel(const T* __restrict__ feat, const int* __restrict__ rb,
            const T* __restrict__ w, T* __restrict__ out,
            float* __restrict__ part, int* __restrict__ flags, int K, int M,
            int Mout, int Cin, int Cout, int miss, int taps_per_split,
            int flip, int vec_a, int vec_b) {
  using C = ConvTile<T, BN, BK, WT>;
  constexpr int ES = C::ES;
  constexpr int MT = 2, NT = BN / 16;      // warp tile: 32 rows x BN / 2
  constexpr int KSTEP = ES == 2 ? 16 : 8;  // the MMA's depth
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kStages = C::STAGES;
  int* s_idx = reinterpret_cast<int*>(smem + kStages * C::STAGE_BYTES);
  __shared__ unsigned s_mask[2 * kMaxTaps];
  __shared__ int s_taps[kMaxTaps];
  __shared__ int s_ntaps;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * kTileM, n0 = blockIdx.y * BN;
  const int k0 = blockIdx.z * taps_per_split;
  const int nk = min(K - k0, taps_per_split);

  // the tile's partner rows for every tap of the group, once; -1 = miss.
  // A warp takes 32 rows of a tap at a time and has eight such loads in
  // flight before it stores them.
  constexpr int kLoads = 8;
  for (int p0 = warp; p0 < 2 * nk; p0 += kLoads * (kThreads / 32)) {
    int idx[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int p = p0 + u * (kThreads / 32), j = p >> 1;
      const int m = m0 + (p & 1) * 32 + lane;
      const int k = flip ? K - 1 - (k0 + j) : k0 + j;
      idx[u] = p < 2 * nk && m < M ? __ldg(rb + (long long)k * M + m) : miss;
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int p = p0 + u * (kThreads / 32);
      if (p >= 2 * nk) break;
      const bool hit = (unsigned)idx[u] < (unsigned)miss;
      s_idx[(p >> 1) * kTileM + (p & 1) * 32 + lane] = hit ? idx[u] : -1;
      const unsigned mask = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) s_mask[p] = mask;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // the taps with a partner in this tile
    int n = 0;
    for (int j = 0; j < nk; ++j)
      if (s_mask[2 * j] | s_mask[2 * j + 1]) s_taps[n++] = j;
    s_ntaps = n;
  }
  __syncthreads();
  const int ntaps = s_ntaps;
  const int nchunks = (Cin + BK - 1) / BK;
  const int nsteps = ntaps * nchunks;

  // stage step s into ring slot `slot`: the 64 gathered rows [64, BK] and
  // W_k's [BK, BN] slice ([BN, BK] when WT), zero-filled past Cin / Cout
  const int ea = vec_a / ES, sha = __ffs(BK / ea) - 1;
  const int eb = vec_b / ES;
  const int shb = __ffs((WT ? BK : BN) / eb) - 1;
  auto load = [&](int s, int slot) {
    const int j = s_taps[s / nchunks], c0 = (s % nchunks) * BK;
    T* As = reinterpret_cast<T*>(smem + slot * C::STAGE_BYTES);
    T* Bs = As + C::A_ELEMS;
    const int* idx = s_idx + j * kTileM;
    for (int e = threadIdx.x; e < (kTileM << sha); e += kThreads) {
      const int r = e >> sha, cc = (e & ((1 << sha) - 1)) * ea;
      const int row = idx[r], c = c0 + cc;
      const bool ok = row >= 0 && c < Cin;
      cp_async_vec(smem_addr(As + r * C::LDA + cc),
                   ok ? feat + (long long)row * Cin + c : feat, ok, vec_a);
    }
    const T* wk = w + (long long)(k0 + j) * Cin * Cout;
    if constexpr (WT) {  // stored [Cout][Cin]: BN rows n, BK columns c
      for (int e = threadIdx.x; e < (BN << shb); e += kThreads) {
        const int r = e >> shb, cc = (e & ((1 << shb) - 1)) * eb;
        const int n = n0 + r, c = c0 + cc;
        const bool ok = n < Cout && c < Cin;
        cp_async_vec(smem_addr(Bs + r * C::LDB + cc),
                     ok ? wk + (long long)n * Cin + c : w, ok, vec_b);
      }
    } else {  // stored [Cin][Cout]: BK rows c, BN columns n
      for (int e = threadIdx.x; e < (BK << shb); e += kThreads) {
        const int r = e >> shb, nn = (e & ((1 << shb) - 1)) * eb;
        const int c = c0 + r, n = n0 + nn;
        const bool ok = c < Cin && n < Cout;
        cp_async_vec(smem_addr(Bs + r * C::LDB + nn),
                     ok ? wk + (long long)c * Cout + n : w, ok, vec_b);
      }
    }
  };

  const int wm = warp >> 1, wn = warp & 1;
  // acc: the tile's sum. aux: bf16, one step's products, added to acc after
  // the step; fp32, the 3xTF32 cross products of all steps (tensor_core.cuh)
  float acc[MT][NT][4], aux[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = aux[i][j][q] = 0.f;

  // The tensor cores' accumulation truncates: carried over 27 taps x Cin on
  // one accumulator it lost fp32 accuracy on the card. bf16 adds each
  // step's products (two MMAs deep) to acc in fp32; fp32 adds every hi*hi
  // MMA to acc in fp32 (tensor_core.cuh mma_3xtf32).
  // `rows` is the hit mask of the warp's 32 rows at the step's tap: a
  // 16-row MMA tile with no partner there is skipped.
  auto compute = [&](int slot, unsigned rows) {
    const T* As = reinterpret_cast<const T*>(smem + slot * C::STAGE_BYTES);
    const T* Bs = As + C::A_ELEMS;
    bool act[MT];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) act[mt] = (rows >> (16 * mt)) & 0xffffu;
    if (!rows) return;
#pragma unroll
    for (int kk = 0; kk < BK; kk += KSTEP) {
      uint32_t a[MT][4] = {};
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        if (act[mt])
          ldsm_x4(a[mt], smem_addr(As + (wm * 32 + mt * 16 + (lane & 15))
                                   * C::LDA + kk + (lane >> 4) * (16 / ES)));
      if constexpr (ES == 2) {
#pragma unroll
        for (int np = 0; np < NT; np += 2) {
          const int nb = wn * (BN / 2) + np * 8;
          uint32_t b[4];
          if constexpr (WT)
            ldsm_x4(b, smem_addr(Bs + (nb + (lane & 7) + ((lane >> 4) << 3))
                                 * C::LDB + kk + (((lane >> 3) & 1) << 3)));
          else
            ldsm_x4_t(b, smem_addr(Bs + (kk + (lane & 7)
                                         + (((lane >> 3) & 1) << 3)) * C::LDB
                                   + nb + ((lane >> 4) << 3)));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            if (!act[mt]) continue;
            mma_bf16(aux[mt][np], a[mt], b[0], b[1]);
            mma_bf16(aux[mt][np + 1], a[mt], b[2], b[3]);
          }
        }
      } else {
        uint32_t ahi[MT][4], alo[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (act[mt])
              split_tf32(__uint_as_float(a[mt][q]), ahi[mt][q], alo[mt][q]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int nb = wn * (BN / 2) + nt * 8;
          float b0, b1;
          if constexpr (WT) {
            b0 = Bs[(nb + g) * C::LDB + kk + t];
            b1 = Bs[(nb + g) * C::LDB + kk + t + 4];
          } else {
            b0 = Bs[(kk + t) * C::LDB + nb + g];
            b1 = Bs[(kk + t + 4) * C::LDB + nb + g];
          }
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(b0, bh0, bl0);
          split_tf32(b1, bh1, bl1);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            if (act[mt])
              mma_3xtf32(acc[mt][nt], aux[mt][nt], ahi[mt], alo[mt], bh0,
                         bh1, bl0, bl1);
        }
      }
    }
    if constexpr (ES == 2) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc[i][j][q] += aux[i][j][q];
            aux[i][j][q] = 0.f;
          }
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nsteps) load(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // step s landed; every warp is done with step s - 1
    if (s + kStages - 1 < nsteps) load(s + kStages - 1, (s + kStages - 1) % kStages);
    cp_async_commit();
    compute(s % kStages, s_mask[2 * s_taps[s / nchunks] + wm]);
  }
  cp_async_wait<0>();
  if constexpr (ES == 4) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] += aux[i][j][q];
  }

  T* dst = out;
  float* pdst = nullptr;
  if (gridDim.z > 1) {
    if (threadIdx.x == 0 && blockIdx.y == 0)
      flags[blockIdx.z * gridDim.x + blockIdx.x] = ntaps > 0;
    if (ntaps == 0) return;  // conv_reduce skips this group's tile
    pdst = part + (long long)blockIdx.z * Mout * Cout;
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 32 + mt * 16 + g + 8 * h;
      if (m >= Mout) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int c = n0 + wn * (BN / 2) + nt * 8 + 2 * t;
        const float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
        if (pdst != nullptr)
          store_pair(pdst + (long long)m * Cout, c, Cout, v0, v1);
        else
          store_pair(dst + (long long)m * Cout, c, Cout, v0, v1);
      }
    }
  }
}

// out[i] = sum over tap groups s, in group order, of part[s, i], skipping
// a group whose block found no partner in i's tile (it wrote no partial).
template <typename T>
__global__ void __launch_bounds__(256)
conv_reduce(const float* __restrict__ part, const int* __restrict__ flags,
            T* __restrict__ out, long long n, int Cout, int nsplit,
            int tiles) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  const int tile = (int)(i / Cout / kTileM);
  float acc = 0.f;
  for (int s = 0; s < nsplit; ++s)
    if (flags[s * tiles + tile]) acc += part[s * n + i];
  out[i] = from_f32<T>(acc);
}

struct Args {
  const void* feat;
  const int* rb;
  const void* w;
  void* out;
  float* part;
  int* flags;
  int K, M, Mout, Cin, Cout, miss, nsplit, flip, vec_a, vec_b;
  cudaStream_t st;
};

template <typename T, int BN, int BK, bool WT>
int launch_tile(const Args& a) {
  using C = ConvTile<T, BN, BK, WT>;
  auto kern = conv_kernel<T, BN, BK, WT>;
  static bool sized = false;  // dynamic shared memory above 48 KB, once
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::MAX_SMEM);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const int tps = (a.K + a.nsplit - 1) / a.nsplit;
  const size_t smem = (size_t)C::STAGES * C::STAGE_BYTES + (size_t)tps * kTileM * 4;
  const int tiles = (a.Mout + kTileM - 1) / kTileM;
  const dim3 grid((unsigned)tiles, (unsigned)((a.Cout + BN - 1) / BN),
                  (unsigned)a.nsplit);
  kern<<<grid, kThreads, smem, a.st>>>(
      static_cast<const T*>(a.feat), a.rb, static_cast<const T*>(a.w),
      static_cast<T*>(a.out), a.part, a.flags, a.K, a.M, a.Mout, a.Cin,
      a.Cout, a.miss, tps, a.flip, a.vec_a, a.vec_b);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.nsplit == 1) return (int)e;
  const long long n = (long long)a.Mout * a.Cout;
  conv_reduce<T><<<(unsigned)((n + 255) / 256), 256, 0, a.st>>>(
      a.part, a.flags, static_cast<T*>(a.out), n, a.Cout, a.nsplit, tiles);
  return (int)cudaGetLastError();
}

template <typename T, int BN>
int launch_bn(const Args& a, bool wt) {
  if (wt) return launch_tile<T, BN, 32, true>(a);
  if (a.Cin <= 16) return launch_tile<T, BN, 16, false>(a);
  return launch_tile<T, BN, 32, false>(a);
}

template <typename T>
int launch(const Args& a, bool wt) {
  if (a.Cout <= 32) return launch_bn<T, 32>(a, wt);
  return launch_bn<T, 64>(a, wt);  // groups of 64 columns over blockIdx.y
}

}  // namespace

// feat [rows, Cin], rb [K, M] int32, w [K, Cin, Cout] ([K, Cout, Cin] when
// w_t), out [Mout, Cout] with Mout = M or M + 1; feat/w/out fp32 (bf16 = 0)
// or bf16 (bf16 = 1). nsplit tap groups (1 <= nsplit <= K, each of
// ceil(K / nsplit) <= 32 taps, none empty); with nsplit > 1, part
// [nsplit, Mout, Cout] fp32 and flags [nsplit, ceil(Mout / 64)] int32 are
// scratch. Rows are copied in 16, 8 or 4 bytes, as the widths and the
// alignment of feat and w allow: Cin and Cout times the element size must
// be multiples of 4 bytes and feat, w 4-byte aligned.
extern "C" int rulebook_conv(const void* feat, const void* rb, const void* w,
                             void* out, void* part, void* flags, int K, int M,
                             int Mout, int Cin, int Cout, int miss,
                             int nsplit, int flip_taps, int w_t, int bf16,
                             void* stream) {
  const int es = bf16 ? 2 : 4;
  const int tps = nsplit > 0 ? (K + nsplit - 1) / nsplit : 0;
  Args a{feat, static_cast<const int*>(rb), w, out,
         static_cast<float*>(part), static_cast<int*>(flags), K, M, Mout,
         Cin, Cout, miss, nsplit, flip_taps ? 1 : 0,
         copy_width((long long)Cin * es, feat),
         copy_width((long long)(w_t ? Cin : Cout) * es, w),
         static_cast<cudaStream_t>(stream)};
  if (M < 0 || K <= 0 || Cin <= 0 || Cout <= 0 || Cout > 32768 ||
      (Mout != M && Mout != M + 1) || Mout <= 0 || miss < 0 ||
      nsplit <= 0 || tps > kMaxTaps || (nsplit - 1) * tps >= K ||
      (nsplit > 1 && (part == nullptr || flags == nullptr)) ||
      a.vec_a == 0 || a.vec_b == 0)
    return (int)cudaErrorInvalidValue;
  return bf16 ? launch<__nv_bfloat16>(a, w_t != 0) : launch<float>(a, w_t != 0);
}
