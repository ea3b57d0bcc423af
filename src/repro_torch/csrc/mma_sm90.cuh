// Small inline wrappers for warp-level tensor-core kernels on Hopper (sm_90a):
// asynchronous global-to-shared copies (16, 8 and 4 bytes), ldmatrix, the bf16
// m16n8k16 MMA and the XOR swizzle that keeps ldmatrix free of bank
// conflicts.
//
// Fragment layouts of mma.sync.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major), 4 registers of bf16x2:
//     a0 = (row g,     cols 2t, 2t+1)   a1 = (row g + 8, cols 2t, 2t+1)
//     a2 = (row g,     cols 2t+8, +9)   a3 = (row g + 8, cols 2t+8, +9)
//   B (16 x 8, "col": element (k, n)), 2 registers of bf16x2:
//     b0 = (k 2t, 2t+1; n g)            b1 = (k 2t+8, 2t+9; n g)
//   C/D (16 x 8, fp32), 4 registers:
//     c0, c1 = (row g, cols 2t, 2t+1)   c2, c3 = (row g + 8, cols 2t, 2t+1)
// A C fragment of two neighbouring n8 tiles, packed to bf16x2, is therefore
// the A fragment of one k16 step: the product's result feeds the next product
// without a round trip through shared memory.
//
// Shared-memory tiles hold rows of CHUNKS 16-byte chunks (8 bf16 each); chunk
// c of row r is stored at chunk c ^ (r % 8) of that row.  An 8 x 8 ldmatrix
// reads one chunk of 8 consecutive rows: after the swizzle they fall in 8
// different 16-byte bank groups, so each phase is free of conflicts.  A row
// of 4 chunks (64 bytes) shares a 128-byte line with the next; there chunk c
// of row r is stored at c ^ ((r / 2) % 4), which again puts 8 consecutive
// rows in 8 different bank groups.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, cached in L2 only; with `valid` false nothing is
// read and the 16 bytes are written as zeros (src-size 0)
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            bool valid) {
  const int src_bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

// 4 bytes global -> shared (cached in L1 and L2), zero-filled when `valid`
// is false; for fp32 rows that need not start on a 16-byte boundary
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src,
                                           bool valid) {
  const int src_bytes = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

// 8 bytes global -> shared (cached in L1 and L2), zero-filled when `valid`
// is false; for bf16 rows that start on an 8-byte boundary only
__device__ __forceinline__ void cp_async_8(uint32_t dst, const void* src,
                                           bool valid) {
  const int src_bytes = valid ? 8 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// four 8 x 8 b16 matrices; lane i gives the row address of matrix i / 8,
// row i % 8; register j receives (row lane / 4, cols 2t, 2t+1) of matrix j
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr)
               : "memory");
}

// as ldmatrix_x4, each matrix transposed: register j receives
// (rows 2t, 2t+1; col lane / 4) of matrix j
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr)
               : "memory");
}

// two transposed matrices; lanes 0-15 give the row addresses
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(addr) : "memory");
}

// d += a * b: bf16 inputs, fp32 accumulators
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> bf16x2, round to nearest even; `lo` in the low 16 bits (the
// lower column of a fragment)
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// index, in 16-byte chunks, of chunk `chunk` of row `row` in a swizzled tile
// of CHUNKS chunks a row
template <int CHUNKS>
__device__ __forceinline__ int swizzle(int row, int chunk) {
  static_assert(CHUNKS % 8 == 0 || CHUNKS == 4,
                "a swizzled row holds 4 or whole groups of 8 chunks");
  if constexpr (CHUNKS % 8 == 0)
    return row * CHUNKS + (chunk ^ (row & 7));
  else
    return row * CHUNKS + (chunk ^ ((row >> 1) & 3));
}

}  // namespace sm90
