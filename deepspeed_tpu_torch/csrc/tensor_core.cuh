// Tensor-core building blocks shared by the flash forward and dK/dV (K1, K3), the ragged paged
// attention (K4) and the block-sparse dK/dV (K9) kernels for bf16 and fp16 operands: cp.async
// copies into swizzled shared-memory tiles, ldmatrix fragment loads and mma.sync.m16n8k16 with
// fp32 accumulation.
//
// Fragments follow the PTX ISA's m16n8k16 layouts. Inside a warp, lane = 4 g + t (g = lane / 4,
// t = lane % 4):
//   A (16 x 16, row-major):  a[0] = (g, 2t..2t+1), a[1] = (g+8, 2t..), a[2] = (g, 2t+8..),
//                            a[3] = (g+8, 2t+8..), each two 16-bit values packed low-first;
//   B (16 x 8, "col"):       b[0] = (k 2t..2t+1, n g), b[1] = (k 2t+8.., n g);
//   C (16 x 8, fp32):        c[0..1] = (g, 2t..2t+1), c[2..3] = (g+8, 2t..2t+1).
// So the C fragments of two neighbouring 8-column tiles, rounded and packed in pairs, are the A
// fragment of a 16 x 16 tile: a score tile feeds the next product without shared memory.
//
// Tiles in shared memory are rows of W 16-bit values (W = 64 or 128: 8 or 16 chunks of 16 bytes).
// Chunk c of row r lies at chunk c ^ (r & 7), so the eight rows an ldmatrix reads at one logical
// chunk fall in eight different bank groups: no conflicts, and no padding.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace tc {

// element offset of (row, col) in a swizzled tile of rows of W 16-bit values; col % 8 == 0
template <int W>
__device__ __forceinline__ int swz(int row, int col) {
  return row * W + ((((col >> 3) ^ (row & 7))) << 3);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; `valid` false fills the 16 bytes with zeros and reads
// nothing (src must still be a mapped address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

// 4 bytes (one fp32 row statistic) from global to shared memory, through L1; `valid` false
// zero-fills as above
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8 x 8 matrices of 16-bit values; lane i gives the address of row i % 8 of matrix i / 8
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a b for one 16 x 8 x 16 tile, operands of type T (bf16 or fp16), fp32 accumulators
template <typename T>
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1);

template <>
__device__ __forceinline__ void mma<__nv_bfloat16>(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                                   uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <>
__device__ __forceinline__ void mma<__half>(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to T and packed, x in the low half (the lower column)
template <typename T>
__device__ __forceinline__ uint32_t pack2(float x, float y);

template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float x, float y) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&h);
}

template <>
__device__ __forceinline__ uint32_t pack2<__half>(float x, float y) {
  __half2 h = __floats2half2_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&h);
}

// the packed pair widened back to fp32 (the rounded values pack2 stored)
template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t v);

template <>
__device__ __forceinline__ float2 unpack2<__nv_bfloat16>(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

template <>
__device__ __forceinline__ float2 unpack2<__half>(uint32_t v) {
  return __half22float2(*reinterpret_cast<__half2*>(&v));
}

// a 16 x 16 A fragment from the fp32 C fragments c0 (columns 0-7) and c1 (columns 8-15),
// rounded to T
template <typename T>
__device__ __forceinline__ void a_from_c(uint32_t (&a)[4], const float (&c0)[4], const float (&c1)[4]) {
  a[0] = pack2<T>(c0[0], c0[1]);
  a[1] = pack2<T>(c0[2], c0[3]);
  a[2] = pack2<T>(c1[0], c1[1]);
  a[3] = pack2<T>(c1[2], c1[3]);
}

// the same fp32 values as hi + lo, each rounded to T: hi = T(x), lo = T(x - hi). A product with
// hi and one with lo together carry x to about 2^-16 of its magnitude (bf16) instead of 2^-8.
template <typename T>
__device__ __forceinline__ void a_from_c_split(uint32_t (&hi)[4], uint32_t (&lo)[4], const float (&c0)[4],
                                               const float (&c1)[4]) {
  a_from_c<T>(hi, c0, c1);
  float2 h = unpack2<T>(hi[0]);
  lo[0] = pack2<T>(c0[0] - h.x, c0[1] - h.y);
  h = unpack2<T>(hi[1]);
  lo[1] = pack2<T>(c0[2] - h.x, c0[3] - h.y);
  h = unpack2<T>(hi[2]);
  lo[2] = pack2<T>(c1[0] - h.x, c1[1] - h.y);
  h = unpack2<T>(hi[3]);
  lo[3] = pack2<T>(c1[2] - h.x, c1[3] - h.y);
}

}  // namespace tc
