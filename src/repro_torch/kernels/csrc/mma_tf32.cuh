// float32 products on Hopper's tensor cores through 3xTF32, and the
// cp.async row loader: the building blocks of kernels B6 and B7.
//
// One mma.sync.m16n8k8 with TF32 operands multiplies a 16 x 8 tile of A by
// an 8 x 8 tile of B into a 16 x 8 float32 accumulator held by one warp.
// TF32 keeps 10 stored mantissa bits (about 3 digits), too few for the
// kernels' 1e-5 and 1e-4 tolerances, so every operand is split as
// a = a_hi + a_lo (a_hi = tf32(a), a_lo = tf32(a - a_hi)) and the product is
// a_lo b_hi + a_hi b_lo + a_hi b_hi (the dropped a_lo b_lo is ~2^-22 of it):
// three MMAs (tests/test_torch_tf32x3.py holds this error budget on the
// CPU).  The tensor core's own float32 sums do not round to nearest (they
// truncate), so a long chain of MMAs on one accumulator drifts by more
// than float32 rounding would: the kernels keep the chains short, with a
// fresh accumulator a k-step (B6's C.B^T) or key tile (B7's P.V) added to
// the running sum on the CUDA cores (fold), or with the small passes on
// an accumulator of their own (mma3_split, B6's other products).
//
// Fragment layout of m16n8k8 (PTX ISA, "mma.m16n8k8" with .tf32), for lane
// = 4 g + q (g = lane / 4 in 0..7, q = lane % 4 in 0..3):
//   A (16 x 8, row): a0 (g, q)  a1 (g + 8, q)  a2 (g, q + 4)  a3 (g + 8, q + 4)
//   B (8 x 8, col):  b0 (k = q, n = g)          b1 (k = q + 4, n = g)
//   C (16 x 8):      c0 (g, 2q) c1 (g, 2q + 1)  c2 (g + 8, 2q) c3 (g + 8, 2q + 1)
// Fragments are gathered element by element from shared or global memory,
// so an operand's layout in memory is free: a transposed operand is read
// with transposed indices.  A shared tile read as (row g, column q) takes a
// row stride = 4 (mod 32) floats, one read as (row q, column g) a stride =
// 8 (mod 32), so that the warp's 32 reads fall in 32 distinct banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

namespace tf32x3 {

// x = hi + lo.  hi is x rounded to TF32 (to nearest, ties away from zero)
// by two integer operations on its bits; lo = x - hi is exact in float32,
// and the tensor core reads it as TF32 by ignoring its 13 low mantissa bits
// (truncation: an error of at most 2^-10 of lo, itself at most 2^-11 of
// x).  Finite inputs only.  (cvt.rna.tf32.f32 compiles for sm_90a into a
// branching sequence of a dozen instructions.)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

struct FragA {
  uint32_t hi[4], lo[4];
};

struct FragB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ void set_a(FragA& a, float a0, float a1, float a2,
                                      float a3) {
  split(a0, a.hi[0], a.lo[0]);
  split(a1, a.hi[1], a.lo[1]);
  split(a2, a.hi[2], a.lo[2]);
  split(a3, a.hi[3], a.lo[3]);
}

__device__ __forceinline__ void set_b(FragB& b, float b0, float b1) {
  split(b0, b.hi[0], b.lo[0]);
  split(b1, b.hi[1], b.lo[1]);
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[j] += a b[j] for j < n, in 3xTF32, the small terms first.  Each pass
// runs over every j before the next pass starts, so that consecutive MMAs
// write different accumulators: three passes on one accumulator in a row
// would wait on each other's latency.
template <int J>
__device__ __forceinline__ void mma3(float (&d)[J][4], const FragA& a,
                                     const FragB (&b)[J], int n = J) {
#pragma unroll
  for (int j = 0; j < J; ++j)
    if (j < n) mma(d[j], a.lo, b[j].hi);
#pragma unroll
  for (int j = 0; j < J; ++j)
    if (j < n) mma(d[j], a.hi, b[j].lo);
#pragma unroll
  for (int j = 0; j < J; ++j)
    if (j < n) mma(d[j], a.hi, b[j].hi);
}

// big[j] += a_hi b_hi[j] and small[j] += a_lo b_hi[j] + a_hi b_lo[j]: the
// two small passes on an accumulator of their own, so that a chain of
// k-steps truncates the large partial sum once a k-step, not three times
// (the small passes' sums are 2^-11 of it, and so is their truncation).
// The caller folds small into big at the end of the product.
template <int J>
__device__ __forceinline__ void mma3_split(float (&big)[J][4],
                                           float (&small)[J][4],
                                           const FragA& a, const FragB (&b)[J],
                                           int n = J) {
#pragma unroll
  for (int j = 0; j < J; ++j)
    if (j < n) mma(small[j], a.lo, b[j].hi);
#pragma unroll
  for (int j = 0; j < J; ++j)
    if (j < n) mma(small[j], a.hi, b[j].lo);
#pragma unroll
  for (int j = 0; j < J; ++j)
    if (j < n) mma(big[j], a.hi, b[j].hi);
}

template <int J>
__device__ __forceinline__ void zero(float (&d)[J][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[j][e] = 0.0f;
}

// acc[j] += part[j] for j < J, float32 adds on the CUDA cores (round to
// nearest): how a fresh accumulator's product joins the running sum.
template <int J>
__device__ __forceinline__ void fold(float (&acc)[J][4],
                                     const float (&part)[J][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
}

// 16 bytes global -> shared, asynchronous; zeros when !valid (src-size 0:
// nothing is read, but src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most n of this thread's committed groups are in flight.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// rows x cols elements of a row-major source (row stride rs elements, dense
// columns) into a float32 shared tile of row stride ld floats, rows >=
// valid as zeros, by the block's NT threads.  With `async` (float32 only,
// cols % 4 == 0, 16-byte aligned rows: see aligned16), 16-byte cp.async
// copies the caller commits and waits for, else plain loads and stores.
// Row 0 of src must exist: a zero-filled copy still names an address.
template <int NT, typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src,
                                          long long rs, int rows, int valid,
                                          int cols, bool async) {
  if constexpr (std::is_same<T, float>::value) {
    if (async) {
      const int c4 = cols / 4;
      for (int i = threadIdx.x; i < rows * c4; i += NT) {
        const int r = i / c4, c = (i % c4) * 4;
        const bool ok = r < valid;
        cp_async16(dst + r * ld + c, src + (ok ? r * rs : 0) + c, ok);
      }
      return;
    }
  }
  for (int i = threadIdx.x; i < rows * cols; i += NT) {
    const int r = i / cols, c = i % cols;
    dst[r * ld + c] = r < valid ? to_float(src[r * rs + c]) : 0.0f;
  }
}

// Whether load_rows may copy by cp.async: a 16-byte aligned base and
// element strides that are multiples of 4 floats.
inline bool aligned16(const void* p, std::initializer_list<long long> strides) {
  if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  for (long long s : strides)
    if (s % 4) return false;
  return true;
}

}  // namespace tf32x3
