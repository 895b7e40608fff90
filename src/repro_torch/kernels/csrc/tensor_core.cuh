// Warp-level tensor-core and async-copy primitives for sm_90a, shared by
// flash_attention.cu and ssd_scan.cu (inline PTX: mma.sync, ldmatrix,
// cp.async).
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k16" and
// "mma.m16n8k8"), with g = lane / 4 and t = lane % 4:
//   bf16 m16n8k16  A (16 x 16, row): a0 (g, 2t..2t+1)  a1 (g+8, 2t..)
//                                    a2 (g, 2t+8..)    a3 (g+8, 2t+8..)
//                  B (16 x 8, col):  b0 (k 2t..2t+1, n g)  b1 (k 2t+8.., n g)
//   tf32 m16n8k8   A (16 x 8, row):  a0 (g, t) a1 (g+8, t) a2 (g, t+4)
//                                    a3 (g+8, t+4)
//                  B (8 x 8, col):   b0 (k t, n g)  b1 (k t+4, n g)
//   f32 C/D (16 x 8), both shapes:   c0 c1 (g, 2t..2t+1)  c2 c3 (g+8, 2t..)
// A sum over k does not care in which order its terms come, so a caller may
// map the tf32 k index t to column 2t and t+4 to 2t+1 in both A and B: then
// an f32 accumulator tile (columns 2t, 2t+1 in one thread) is an A fragment
// as it stands, and B's two values are neighbours in memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace tc {

// 16 bytes global -> shared, bypassing L1; with ok false nothing is read
// and the 16 bytes are zero-filled (src must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = ok ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most n of this thread's committed groups are in flight
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n));
}

// four 8 x 8 b16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, and register i of lane l holds row l / 4, columns 2(l % 4)..+1
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// the same, each matrix transposed: register i of lane l holds rows
// 2(l % 4)..+1 of column l / 4
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// The products are not `volatile`: they touch no memory, and the compiler
// may interleave products into different accumulators instead of waiting
// out each one's latency in source order.

// d += a b, 16 x 8 x 16, bf16 operands, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b, 16 x 8 x 8, tf32 operands (as b32 bit patterns), f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// v = hi + lo: hi is v cut to tf32 (its top 19 bits, a mask: no cvt,
// which runs on the slow conversion pipe), lo = v - hi is exact in f32 and
// the tensor core reads its top 19 bits.  The product of two split values
// as hi*hi + hi*lo + lo*hi (the 3xTF32 scheme) keeps about f32's accuracy
// (the terms dropped are below 2^-21 of the product); lo*lo is dropped.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(v) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// two floats -> bf16x2 (lo in the low half), rounded to nearest even
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace tc
