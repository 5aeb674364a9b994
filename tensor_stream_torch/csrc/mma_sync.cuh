// Warp-level bf16 products on mma.sync m16n8k16 (f32 accumulate), the
// ldmatrix loads of their fragments from padded shared-memory tiles, and
// cp.async copies global -> shared. The PTX ISA's sections on mma.sync,
// ldmatrix and cp.async define what each wrapper does. Used by the flash
// backward's d = 32/128 kernels and the flash forward's short-sequence
// kernel.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "sm90.cuh"

namespace mma_sync {

__device__ __forceinline__ uint32_t PackBf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void Mma(float* d, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void Ldsm4(uint32_t* r, const __nv_bfloat16* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(sm90::SmemAddr(ptr)));
}

__device__ __forceinline__ void Ldsm4T(uint32_t* r,
                                       const __nv_bfloat16* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(sm90::SmemAddr(ptr)));
}

// mma.sync m16n8k16 fragments, g = lane / 4, t = lane % 4:
//   A (16x16, row-major): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//     a3 (g+8, 2t+8..).
//   B (16x8, k by n): b0 (k = 2t..2t+1, n = g), b1 (k = 2t+8.., n = g).
//   C (16x8): c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1).
// The C fragments of two neighbouring n-tiles are the A fragment of one
// k-step, so P and dS go from one product to the next in registers.

// The A fragment of rows [r0, r0 + 16), columns [c0, c0 + 16) of a
// row-major tile with row pitch ld.
__device__ __forceinline__ void LoadA(uint32_t* a, const __nv_bfloat16* tile,
                                      int ld, int r0, int c0, int lane) {
  Ldsm4(a, tile + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + c0 +
               (lane >> 4) * 8);
}

// B fragments of the n-tiles n0 and n0 + 8 for k in [k0, k0 + 16), from a
// tile stored [n][k] (B = tile^T): b[0..1] for n0, b[2..3] for n0 + 8.
__device__ __forceinline__ void LoadBt(uint32_t* b, const __nv_bfloat16* tile,
                                       int ld, int n0, int k0, int lane) {
  Ldsm4(b, tile + (n0 + (lane & 7) + (lane >> 4) * 8) * ld + k0 +
               ((lane >> 3) & 1) * 8);
}

// The same from a tile stored [k][n] (B = tile), through ldmatrix.trans.
__device__ __forceinline__ void LoadB(uint32_t* b, const __nv_bfloat16* tile,
                                      int ld, int k0, int n0, int lane) {
  Ldsm4T(b, tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 +
                (lane >> 4) * 8);
}

// A fragments of a [16 x 8*NT] product held as C fragments, cast to bf16.
template <int NT>
__device__ __forceinline__ void PackA(uint32_t (*a)[4], const float (*c)[4]) {
#pragma unroll
  for (int kc = 0; kc < NT / 2; ++kc) {
    a[kc][0] = PackBf16(c[2 * kc][0], c[2 * kc][1]);
    a[kc][1] = PackBf16(c[2 * kc][2], c[2 * kc][3]);
    a[kc][2] = PackBf16(c[2 * kc + 1][0], c[2 * kc + 1][1]);
    a[kc][3] = PackBf16(c[2 * kc + 1][2], c[2 * kc + 1][3]);
  }
}

// cp.async copies global -> shared without registers; a source size of 0
// writes zeros (rows past S), and the source must still be a valid address.
__device__ __forceinline__ void CpAsync16(void* dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   sm90::SmemAddr(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void CpAsync4(void* dst, const void* src,
                                         bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   sm90::SmemAddr(dst)),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void CpAsyncCommit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void CpAsyncWait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace mma_sync
