// Building blocks of the rulebook conv kernels (rulebook_conv.cu,
// rulebook_conv_dw.cu) for Hopper (sm_90a): cp.async gathers with
// zero-fill, ldmatrix, and the mma.sync products they run on the tensor
// cores, bf16 (m16n8k16) and fp32 as 3xTF32 (m16n8k8).
//
// fp32 as 3xTF32: each fp32 operand x is split into hi = tf32_rna(x) and
// lo = tf32_rna(x - hi), where tf32_rna rounds to 10 mantissa bits, to
// nearest with ties away from zero (cvt.rna.tf32.f32). The product is
// lo_a*hi_b + hi_a*lo_b + hi_a*hi_b, accumulated in fp32: the products of
// tf32 values are exact in fp32 and only lo_a*lo_b and the rounding of lo
// (about 2^-22 of the product) are lost, so the result keeps close to
// fp32's accuracy where one TF32 product would keep about three decimal
// digits. tests/test_torch_port_conv_tf32.py emulates this on the CPU.
//
// Accumulation: an MMA adds its products to C with truncation, so a long
// chain of MMAs on one C loses about an ulp of C per MMA, always toward
// zero. On the card that cost fp32 accuracy (up to 1e-4 of max|dW| over
// thousands of rows, and 1.2e-3 in a train step's gradients). So the
// big product hi*hi of every MMA step is taken on zeroed registers and
// added to the sum in fp32 (round to nearest), and only the two small
// cross products, about 2^-11 of it, are chained on one C. (Chaining four
// hi*hi MMAs before the add truncates toward zero four times: on the card
// that moved a nearly cancelling BN-bias gradient of a train step from
// below to above 1e-3 of its norm.)

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copies BYTES (4, 8 or 16) from global to shared memory asynchronously;
// valid == false reads nothing and fills the destination with zeros (a
// source size of 0).
template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         bool valid) {
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
                 "l"(src), "n"(BYTES), "r"(n)
                 : "memory");
}

__device__ __forceinline__ void cp_async_vec(uint32_t dst, const void* src,
                                             bool valid, int bytes) {
  if (bytes == 16)
    cp_async<16>(dst, src, valid);
  else if (bytes == 8)
    cp_async<8>(dst, src, valid);
  else
    cp_async<4>(dst, src, valid);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The largest copy width (16, 8 or 4 bytes) that divides a row of `bytes`
// bytes and the alignment of the array `p` holding such rows, or 0 when
// none does.
inline int copy_width(long long bytes, const void* p) {
  const long long a = bytes | (long long)(reinterpret_cast<uintptr_t>(p) & 15);
  return a % 16 == 0 ? 16 : a % 8 == 0 ? 8 : a % 4 == 0 ? 4 : 0;
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// c += a * b, a 16x16 bf16 (row), b 16x8 bf16 (col), c 16x8 fp32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b, a 16x8 tf32 (row), b 8x8 tf32 (col), c 16x8 fp32
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// acc + small += a * b in 3xTF32 from split fragments (see the top of
// this file): hi*hi on zeroed registers, added to acc in fp32; the cross
// products chained on small
__device__ __forceinline__ void mma_3xtf32(float (&acc)[4], float (&small)[4],
                                           const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4],
                                           uint32_t bhi0, uint32_t bhi1,
                                           uint32_t blo0, uint32_t blo1) {
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(d, ahi, bhi0, bhi1);
  mma_tf32(small, alo, bhi0, bhi1);
  mma_tf32(small, ahi, blo0, blo1);
#pragma unroll
  for (int q = 0; q < 4; ++q) acc[q] += d[q];
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

}  // namespace tc
