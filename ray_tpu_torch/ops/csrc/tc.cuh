// Tensor-core building blocks shared by the flash-attention kernels
// (flash_fwd.cu, flash_bwd.cu): swizzled bf16 tiles in shared memory, the
// cp.async copies that fill them, ldmatrix, mma.sync m16n8k16 bf16 -> f32,
// and the register-level helpers around them; for the f32 forward, padded
// f32 tiles, the TF32 hi/lo split and mma.sync m16n8k8 tf32 -> f32.
//
// Fragment layouts of mma.sync.m16n8k16.row.col (g = lane / 4,
// t4 = lane % 4):
//   A (16 x 16, row-major): a[0] = (row g, cols 2 t4 + {0, 1}),
//     a[1] = (row g + 8, same cols), a[2] = (row g, cols 8 + 2 t4 + {0, 1}),
//     a[3] = (row g + 8, those cols);
//   B (16 x 8): b0 = (k 2 t4 + {0, 1}, col g),
//     b1 = (k 8 + 2 t4 + {0, 1}, col g);
//   C (16 x 8, f32): c[0], c[1] = (row g, cols 2 t4 + {0, 1}), c[2], c[3] =
//     (row g + 8, same cols).
// So the C-fragments of two neighbouring n8 tiles, packed to bf16 pairs,
// are one A-fragment of a following product whose k runs over those 16
// columns.
//
// Fragment layouts of mma.sync.m16n8k8.row.col tf32 (32-bit registers):
//   A (16 x 8): a[0] = (row g, col t4), a[1] = (row g + 8, col t4),
//     a[2] = (row g, col t4 + 4), a[3] = (row g + 8, col t4 + 4);
//   B (8 x 8): b0 = (k t4, col g), b1 = (k t4 + 4, col g);
//   C (16 x 8, f32): as above.
// A C-fragment holds columns (2 t4, 2 t4 + 1) of its rows where the
// A-fragment wants (t4, t4 + 4): it is reused as it lies only under a
// relabelling of the k index (slot t4 <- column 2 t4, slot t4 + 4 <-
// column 2 t4 + 1), which the B-fragment must then follow.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace tc {

typedef __nv_bfloat16 bf16;

// element offset of 16-byte chunk c of row r in a [rows, D] bf16 tile:
// chunks are XOR-swizzled by the row's low 3 bits, so the 8 rows an
// ldmatrix phase reads sit in 8 distinct 16-byte bank groups
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  return r * D + ((c ^ (r & 7)) << 3);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte async copy; src_bytes = 0 zero-fills the destination
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a * b, one m16n8k16 bf16 product with f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as one bf16x2 register, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x in one MUFU.EX2 (flushes denormal results to 0; 2^-inf = 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the TF32 value nearest x, ties away from zero (cvt.rna), as f32 bits
// whose low 13 mantissa bits are zero
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo + e with hi = rna(x), lo = rna(x - hi) (x - hi is exact in
// f32) and |e| <= 2^-22 |x|
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// c += a * b, one m16n8k8 tf32 product with f32 accumulation
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[j] += a * b[j] for N n-tiles to f32 accuracy from split operands:
// a_lo b_hi + a_hi b_lo + a_hi b_hi, small terms first (the dropped
// a_lo b_lo is below 2^-22 |ab|); each round of products runs over the N
// tiles, so consecutive products do not wait on each other
template <int N>
__device__ __forceinline__ void mma_tf32x3_n(float (&c)[N][4],
                                             const uint32_t (&a_hi)[4],
                                             const uint32_t (&a_lo)[4],
                                             const uint32_t (&b_hi)[N][2],
                                             const uint32_t (&b_lo)[N][2]) {
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(c[j], a_lo, b_hi[j][0], b_hi[j][1]);
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(c[j], a_hi, b_lo[j][0], b_lo[j][1]);
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(c[j], a_hi, b_hi[j][0], b_hi[j][1]);
}

// copy rows [row0, row0 + R) of one head, D floats each, into an [R, S]
// f32 tile (S - D floats of padding a row), the CTA's THREADS threads
// sharing the 16-byte chunks; rows at or past `limit` are zero-filled
template <int D, int R, int S, int THREADS = 128>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              long long row_stride, int row0,
                                              int limit, int tid) {
  constexpr int C = D / 4;  // 16-byte chunks per row
#pragma unroll
  for (int i = tid; i < R * C; i += THREADS) {
    const int r = i / C, c = i % C;
    const int gr = row0 + r;
    const bool ok = gr < limit;
    cp_async16(dst + r * S + c * 4, ok ? src + gr * row_stride + c * 4 : src,
               ok ? 16 : 0);
  }
}

// copy rows [row0, row0 + R) of one head into a swizzled [R, D] tile, the
// CTA's THREADS threads sharing the 16-byte chunks; rows at or past
// `limit` are zero-filled
template <int D, int R, int THREADS = 128>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long row_stride, int row0,
                                          int limit, int tid) {
  constexpr int C = D / 8;  // 16-byte chunks per row
#pragma unroll
  for (int i = tid; i < R * C; i += THREADS) {
    const int r = i / C, c = i % C;
    const int gr = row0 + r;
    const bool ok = gr < limit;
    cp_async16(dst + swz<D>(r, c), ok ? src + gr * row_stride + c * 8 : src,
               ok ? 16 : 0);
  }
}

}  // namespace tc
}  // namespace
