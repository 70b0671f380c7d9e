// Rank-table pack for Hopper (sm_90a).
//
// Computes, for each row b of an activity bitmap act [B, stride] of int8 0/1
// cells (the first nce cells of a row are the table's; the rest, such as
// the scratch cell that invalid voxels scatter to, are not read),
//   packed[b][c] = rank(c) << 3 | act(c-1) << 2 | act(c) << 1 | act(c+1)
// where rank(c) is the inclusive prefix sum of row b over [0, c] and the
// neighbours outside [0, nce) count as inactive. This is the RankTable of
// lidarseg3d_torch/ops/coords.py; out is [B, nce] int32, contiguous.
//
// Replaces: lidarseg3d_tpu/ops/pallas_rank.py::_pack_kernel (called through
// pack_rank_table once per sample under vmap). The TPU kernel took
// per-block offsets precomputed by XLA and ran a log-step lane-roll prefix
// plus a triangular matmul per block, with a write-only path for empty
// blocks.
//
// What bounds it on the H100: bytes. It must read one byte and write four
// per cell (5 B/cell: 6.9 MB for the 1.39 M-cell SemanticKITTI stage-1
// table, 464 MB for a 92.9 M-cell grid) and does one add per cell.
//
// Design: one launch for all B rows, one pass over the bitmap, a
// single-pass scan with decoupled look-back.
//   - Tiles are 8192-cell windows aligned in the flat [B * nce] output, so
//     every store of a full group is one aligned 16-byte vector store; a
//     window that crosses a row edge is two tiles, one per row. A block
//     takes its tile from a ticket counter (an atomic), not from blockIdx,
//     so every tile it waits for has started.
//   - The block stages its tile's bytes plus one halo cell on each side in
//     shared memory with aligned 16-byte loads (the rows of act need not be
//     aligned: bytes outside the row are masked to zero), so the neighbour
//     bits come from shared memory.
//   - Each thread owns kGroups groups of four cells, group k at tile cells
//     4 * (256 k + t), so that a warp's loads from shared memory and its
//     stores to device memory are contiguous. Block scans over the groups'
//     counts, packed two to a word (16 bits each), give every group its
//     offset in the tile.
//   - A tile with no active cell skips the scans and writes its constant
//     rank << 3, with the halo's bits on its first and last cell (the TPU
//     kernel's empty path).
//   - Look-back: as soon as the block has summed its tile, it publishes the
//     count (flag AGG; the row's first tile publishes its inclusive prefix,
//     flag INC). Warp 0 then reads 128 predecessors a round trip, nearest
//     first, summing counts back to the nearest inclusive prefix, and
//     publishes its own (INC), while the other warps scan the tile. A
//     status word is epoch << 34 | flag << 32 | value, one 64-bit store; a
//     word of another epoch is not ready.
//   - Nothing is reset between calls, and the call's state lives on the
//     device, so the next launch on the stream starts clean whoever issues
//     it, a CUDA graph replay included: word 0 of the workspace is epoch <<
//     32 | tickets taken, so one atomic gives a tile both. The tile that
//     takes the call's last ticket (every other tile has taken its own)
//     sets the word to the next epoch and no tickets. When the 30-bit epoch
//     wraps, the tile that finishes last (a count in word 1) also clears
//     the status words, as a word of the new epoch may be ready from 2^30
//     calls before.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroups = 8;                          // 4-cell groups a thread
constexpr int kTile = kThreads * kGroups * 4;       // 8192 cells
constexpr int kPairs = kGroups / 2;
constexpr int kLook = 4;  // status words a lane reads in the look-back
constexpr int kRawWords = (kTile + 32) / 4;         // tile + halo + alignment
constexpr unsigned long long kAgg = 1ull, kInc = 2ull;
constexpr unsigned long long kEpochMask = (1ull << 30) - 1;
constexpr int kHeader = 2;  // ws words before the status words

__device__ __forceinline__ unsigned long long status_word(
    unsigned long long epoch, unsigned long long flag, unsigned value) {
  return (epoch << 34) | (flag << 32) | value;
}

__device__ __forceinline__ int warp_inclusive_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += n;
  }
  return v;
}

// the tile's rows: ticket v -> (row b, first tile of the row, window w)
__device__ __forceinline__ void tile_of(long long v, int B, long long nce,
                                        int* b_out, long long* first_out,
                                        long long* w_out) {
  long long first = 0;
  int b = 0;
  for (; b < B - 1; ++b) {
    const long long wf = (long long)b * nce / kTile;
    const long long cnt = ((long long)(b + 1) * nce - 1) / kTile - wf + 1;
    if (v < first + cnt) break;
    first += cnt;
  }
  *b_out = b;
  *first_out = first;
  *w_out = (long long)b * nce / kTile + (v - first);
}

__device__ __forceinline__ unsigned byte_at(const uint32_t* raw, int p) {
  return (raw[p >> 2] >> (8 * (p & 3))) & 0xffu;
}

__global__ void __launch_bounds__(kThreads)
rank_pack_kernel(const int8_t* __restrict__ act, long long stride, int B,
                 long long nce, int* __restrict__ out,
                 unsigned long long* ws, long long cap) {
  __shared__ __align__(16) uint32_t raw[kRawWords];
  __shared__ int s_wsum[kPairs][kWarps];
  __shared__ long long s_tile;
  __shared__ unsigned long long s_epoch;
  __shared__ int s_total, s_excl, s_last;
  unsigned long long* status = ws + kHeader;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

  if (t == 0) {
    const unsigned long long got = atomicAdd(ws, 1ull);
    s_tile = (long long)(got & 0xffffffffull);
    s_epoch = got >> 32;
    s_total = 0;
    if (s_tile == gridDim.x - 1ll)
      atomicExch(ws, ((s_epoch + 1) & kEpochMask) << 32);
  }
  __syncthreads();
  const long long v = s_tile;
  const unsigned long long epoch = s_epoch;
  int b;
  long long first, w;
  tile_of(v, B, nce, &b, &first, &w);
  const long long e0 = w * kTile;                  // flat output index
  const long long rlo = (long long)b * nce, rhi = rlo + nce;

  // stage act cells [e0 - rlo - 1, e0 - rlo + kTile] of row b: raw byte
  // off + i holds tile cell i, off in [1, 16]
  const uintptr_t row = reinterpret_cast<uintptr_t>(act) + b * stride;
  const uintptr_t a_first = row + (e0 - rlo - 1);
  const uintptr_t a_base = a_first & ~(uintptr_t)15;
  const int off = (int)(a_first - a_base) + 1;
  const int nchunk = (off + kTile + 1 + 15) >> 4;
  for (int k = t; k < nchunk; k += kThreads) {
    const uintptr_t a = a_base + 16 * (uintptr_t)k;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (a + 16 > row && a < row + nce) {
      x = __ldg(reinterpret_cast<const uint4*>(a));
      if (a < row || a + 16 > row + nce) {
        uint32_t m[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          if (a + i < row || a + i >= row + nce)
            m[i >> 2] &= ~(0xffu << (8 * (i & 3)));
        }
        x = make_uint4(m[0], m[1], m[2], m[3]);
      }
    }
    reinterpret_cast<uint4*>(raw)[k] = x;
  }
  __syncthreads();

  // the groups' cells, one byte each, their counts, and the tile's count
  const int r = off & 3;
  uint32_t g[kGroups];
  int c[kGroups];
  int mine = 0;
#pragma unroll
  for (int k = 0; k < kGroups; ++k) {
    const int q = (off >> 2) + k * kThreads + t;
    g[k] = __funnelshift_r(raw[q], raw[q + 1], 8 * r);
    c[k] = (int)((g[k] * 0x01010101u) >> 24);
    mine += c[k];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mine += __shfl_xor_sync(0xffffffffu, mine, o);
  if (lane == 0 && mine) atomicAdd(&s_total, mine);
  __syncthreads();
  const int total = s_total;
  const bool empty = total == 0;

  // publish the tile's count at once (the row's first tile: its inclusive
  // prefix); warp 0 then looks back while the other warps scan
  if (t == 0)
    *reinterpret_cast<volatile unsigned long long*>(status + v) =
        status_word(epoch, v == first ? kInc : kAgg, (unsigned)total);
  if (warp == 0) {
    int excl = 0;
    // kLook predecessors a lane, 32 kLook a round trip, nearest first,
    // back to the row's first tile (whose status is an inclusive prefix);
    // a word is ready once it carries this call's epoch and a flag
    for (long long pred = v - 1; v != first; pred -= kLook * 32) {
      unsigned long long w[kLook];
#pragma unroll
      for (int u = 0; u < kLook; ++u) {
        const long long idx = pred - kLook * lane - u;
        w[u] = idx >= first
                   ? *reinterpret_cast<volatile unsigned long long*>(
                         status + idx)
                   : status_word(epoch, kAgg, 0u);
      }
      bool ready;
      do {
        ready = true;
#pragma unroll
        for (int u = 0; u < kLook; ++u) {
          if ((w[u] >> 34) != epoch || ((w[u] >> 32) & 3ull) == 0) {
            ready = false;
            w[u] = *reinterpret_cast<volatile unsigned long long*>(
                status + (pred - kLook * lane - u));
          }
        }
      } while (!ready);
      int sum = 0;
      bool inc = false;
#pragma unroll
      for (int u = 0; u < kLook; ++u) {
        if (!inc) {
          sum += (int)(unsigned)w[u];
          inc = ((w[u] >> 32) & 3ull) == kInc;
        }
      }
      const unsigned incs = __ballot_sync(0xffffffffu, inc);
      const int stop = incs ? __ffs(incs) - 1 : 31;
      int val = lane <= stop ? sum : 0;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        val += __shfl_xor_sync(0xffffffffu, val, o);
      excl += val;
      if (incs) {
        if (lane == 0)
          *reinterpret_cast<volatile unsigned long long*>(status + v) =
              status_word(epoch, kInc, (unsigned)(excl + total));
        break;
      }
    }
    if (lane == 0) s_excl = excl;
  }

  // the groups' counts packed two to a word and scanned over the block; a
  // group column's sum is at most 4 * kThreads = 1024, so the halves never
  // carry into each other
  int x[kPairs], incl[kPairs];
  if (!empty) {
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      x[p] = c[2 * p] | (c[2 * p + 1] << 16);
      incl[p] = warp_inclusive_scan(x[p]);
      if (lane == 31) s_wsum[p][warp] = incl[p];
    }
  }
  __syncthreads();
  const int excl = s_excl;
  int excl_k[kGroups];  // rank before each group, in the tile
  if (!empty) {
    int run = 0;  // the tile's cells in the groups before pair p
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      int before = 0, tot = 0;
#pragma unroll
      for (int w2 = 0; w2 < kWarps; ++w2) {
        before += w2 < warp ? s_wsum[p][w2] : 0;
        tot += s_wsum[p][w2];
      }
      const int e = before + incl[p] - x[p];
      excl_k[2 * p] = run + (e & 0xffff);
      excl_k[2 * p + 1] = run + (tot & 0xffff) + (e >> 16);
      run += (tot & 0xffff) + (tot >> 16);
    }
  }

#pragma unroll
  for (int k = 0; k < kGroups; ++k) {
    const int cell = 4 * (k * kThreads + t);  // tile cell of the group
    const long long e = e0 + cell;
    int o[4];
    if (empty) {
      const int base = excl << 3;
      o[0] = o[1] = o[2] = o[3] = base;
      if (cell == 0) o[0] |= (int)byte_at(raw, off - 1) << 2;
      if (cell == kTile - 4) o[3] |= (int)byte_at(raw, off + kTile);
    } else {
      const int p = off + cell;
      int prev = (int)byte_at(raw, p - 1);
      const int after = (int)byte_at(raw, p + 4);
      int rank = excl + excl_k[k];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int cur = (int)((g[k] >> (8 * i)) & 0xffu);
        const int nxt = i < 3 ? (int)((g[k] >> (8 * (i + 1))) & 0xffu)
                              : after;
        rank += cur;
        o[i] = (rank << 3) | (prev << 2) | (cur << 1) | nxt;
        prev = cur;
      }
    }
    if (e >= rlo && e + 4 <= rhi) {
      *reinterpret_cast<int4*>(out + e) = make_int4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (e + i >= rlo && e + i < rhi) out[e + i] = o[i];
    }
  }

  // the epoch wraps after this call: the last tile to finish clears the
  // status words (the same branch for every tile of the call)
  if (epoch == kEpochMask) {
    __syncthreads();
    if (t == 0) {
      __threadfence();
      s_last = atomicAdd(ws + 1, 1ull) == gridDim.x - 1ull;
    }
    __syncthreads();
    if (s_last) {
      for (long long i = t; i < cap; i += kThreads) status[i] = 0ull;
      if (t == 0) ws[1] = 0ull;
    }
  }
}

// Tiles of one call: the sum over rows of the kTile-cell output windows
// each row touches (ops/rank_pack.py tile_count, which sizes the status
// workspace by it).
long long tile_count(long long B, long long nce) {
  long long n = 0;
  for (long long b = 0; b < B; ++b)
    n += ((b + 1) * nce - 1) / kTile - b * nce / kTile + 1;
  return n;
}

}  // namespace

// act [B, stride] int8 (row b at act + b * stride, any alignment), out
// [B, nce] int32 contiguous and 16-byte aligned; ws [2 + cap] uint64, zero
// before its first call and then left to the kernel: ws[0] the epoch <<
// 32 | tickets taken, ws[1] the finished tiles of a call that wraps the
// epoch, then cap tile status words. Calls that share ws run one after
// another (one stream).
extern "C" int rank_pack(const void* act, long long stride, long long B,
                         long long nce, void* out, void* ws, long long cap,
                         void* stream) {
  const long long tiles = tile_count(B, nce);
  if (B <= 0 || B > 65535 || nce <= 0 || nce >= (1ll << 28) ||
      stride < 0 || tiles > cap || tiles > 0x7fffffffLL ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  rank_pack_kernel<<<(unsigned)tiles, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(act), stride, (int)B, nce,
      static_cast<int*>(out), static_cast<unsigned long long*>(ws), cap);
  return (int)cudaGetLastError();
}
