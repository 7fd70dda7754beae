// The tensor-core tile code of conv3x3.cu's general variant
// (conv3x3_general_kernel): ldmatrix loads of 8x8 bf16 matrices from
// shared memory and the mma.sync m16n8k16 bf16 product with float32
// accumulation (sm_80 and later; run here on sm_90a).
//
// Fragment layouts (PTX ISA, "Matrix Fragments for mma.m16n8k16"), for a
// lane l with g = l / 4 and q = l % 4:
//   A (16 x 16, row-major)  a[0] = (g, 2q..2q+1)     a[1] = (g+8, 2q..2q+1)
//                           a[2] = (g, 2q+8..2q+9)   a[3] = (g+8, 2q+8..2q+9)
//   B (16 x 8, col-major)   b[0] = (2q..2q+1, g)     b[1] = (2q+8..2q+9, g)
//   C (16 x 8, float32)     c[0..1] = (g, 2q..2q+1)  c[2..3] = (g+8, 2q..2q+1)
// A is loaded from a [row][k] buffer (k contiguous) with ldsm_x4, lane l
// giving the address of row l % 16 at k + 8 (l / 16).  B is loaded from a
// [n][k] buffer with ldsm_x4 (b_rows_nk gives the lane's row), which gives
// the fragments of two neighbouring n8 tiles: r[0], r[1] the first's b[0],
// b[1], and r[2], r[3] the second's.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma_tile {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a b on one m16n8k16 tile: bf16 operands, float32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The lane's A row (0..15) and k offset (0 or 8) for ldsm_x4.
__device__ __forceinline__ int a_row(int lane) { return lane & 15; }
__device__ __forceinline__ int a_k(int lane) { return (lane >> 4) * 8; }

// [n][k] B buffer, ldsm_x4: the lane's n row (0..15) and k offset (0 or 8)
__device__ __forceinline__ int b_rows_nk(int lane) {
  return (lane & 7) + ((lane >> 4) << 3);
}
__device__ __forceinline__ int b_k_nk(int lane) { return ((lane >> 3) & 1) * 8; }

// One k16 step of a warp's MT x NT tile: A fragments from a_addr[mt], B
// fragment pairs from b_addr[j] (n tiles 2j and 2j + 1).
template <int MT, int NT>
__device__ __forceinline__ void warp_k16(float (&acc)[MT][NT][4],
                                         const uint32_t (&a_addr)[MT],
                                         const uint32_t (&b_addr)[NT / 2]) {
  uint32_t b[NT / 2][4];
#pragma unroll
  for (int j = 0; j < NT / 2; ++j) ldsm_x4(b[j], b_addr[j]);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    uint32_t a[4];
    ldsm_x4(a, a_addr[mt]);
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      mma_bf16(acc[mt][2 * j], a, b[j][0], b[j][1]);
      mma_bf16(acc[mt][2 * j + 1], a, b[j][2], b[j][3]);
    }
  }
}

}  // namespace mma_tile
