// Split-TF32 products on Hopper's tensor cores through warp-level
// mma.sync (m16n8k8, TF32 in, fp32 accumulate), for K2's fp32 kernels.
//
// A TF32 operand keeps 10 of fp32's 23 mantissa bits, so one TF32 product
// is off by ~2^-11 relative: too coarse for the fp32 parity phases, which
// hold the card to 1e-4 of the CPU.  Each fp32 operand x is split in
// registers into hi = rna(x) and lo = rna(x - hi) (rna: round to nearest,
// ties away, to TF32; x - hi is exact in fp32), and a product is formed as
//     a_lo b_hi + a_hi b_lo + a_hi b_hi
// into one fp32 accumulator, the small terms first: three mma.sync a
// k-step.  The dropped a_lo b_lo and the bits below lo leave ~2^-21
// relative, near fp32's own rounding of the sum.  ref.py's tf32_matmul is
// the plain model of this arithmetic.
//
// Fragments of mma.sync.m16n8k8 with TF32 operands, lane = 4 g + t:
//   A (16 x 8): a0 = (g, t), a1 = (g + 8, t), a2 = (g, t + 4),
//               a3 = (g + 8, t + 4)
//   B (8 x 8):  b0 = (k = t, n = g), b1 = (k = t + 4, n = g)
//   C (16 x 8): c0, c1 = (g, 2t), (g, 2t + 1); c2, c3 = (g + 8, 2t),
//               (g + 8, 2t + 1)
// Tiles live in shared memory as row-major fp32 with a row stride
// S = D + 4 floats (S = 4 mod 32), which every read below takes without a
// bank conflict (see the loads).
//
// An accumulator becomes the A operand of the next product without a trip
// through shared memory: the reduction order inside a k-step is free, so
// k-position t stands for column 2t and t + 4 for column 2t + 1 of the
// accumulator's 8 columns.  Then a0..a3 = c0, c2, c1, c3 (acc_to_a), and
// the B operand reads its k rows in the same order (load_b_kn).
#pragma once

#include "hopper.cuh"

namespace tf32 {

// One operand, split: hi and lo are TF32 values in fp32 bit patterns.
struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

// Round to TF32, to nearest with ties away from zero: add half a TF32 ulp
// to the bit pattern and clear the 13 bits below the mantissa.  For finite
// x this is cvt.rna.tf32.f32 bit for bit, on the integer pipes.
__device__ __forceinline__ uint32_t round_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = round_tf32(x);
  lo = round_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a b into a fresh accumulator: C is a zero register, so d needs no
// zeroing of its own.
__device__ __forceinline__ void mma_fresh(float (&d)[4],
                                          const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// d += a b to full fp32 accuracy: three TF32 products, small terms first.
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma(d, a.lo, b.hi[0], b.hi[1]);
  mma(d, a.hi, b.lo[0], b.lo[1]);
  mma(d, a.hi, b.hi[0], b.hi[1]);
}

// d += a b as mma3 forms it, for an accumulator that sums over a long
// reduction.  The tensor cores' accumulator does not round to nearest:
// each product added into it loses up to an ulp of it, toward zero, so an
// accumulator that takes three products a k-step drifts over a long
// reduction (dK and dV of a 4096-row backward by 4.5e-5 relative on an
// H100, past the kernels' 5e-5 against their model).  Here the two small
// products go into a fresh accumulator, added to d in fp32 (rounded to
// nearest), and only the large one goes into d: one truncation of d a
// k-step, not three (1.7e-5 over 4096 rows).  All three in the fresh
// accumulator would truncate d never, but holds four more registers a
// product for longer, which spills the dK/dV kernel.
__device__ __forceinline__ void mma3_rn(float (&d)[4], const FragA& a,
                                        const FragB& b) {
  float t[4];
  mma_fresh(t, a.lo, b.hi[0], b.hi[1]);
  mma(t, a.hi, b.lo[0], b.lo[1]);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += t[e];
  mma(d, a.hi, b.hi[0], b.hi[1]);
}

__device__ __forceinline__ FragA split_a(float x0, float x1, float x2,
                                         float x3) {
  FragA f;
  split(x0, f.hi[0], f.lo[0]);
  split(x1, f.hi[1], f.lo[1]);
  split(x2, f.hi[2], f.lo[2]);
  split(x3, f.hi[3], f.lo[3]);
  return f;
}

// A = rows [r0, r0 + 16), reduction columns [k0, k0 + 8) of a row-major
// tile (row stride S).  Lane (g, t) reads word g S + t: banks 4 g + t.
template <int S>
__device__ __forceinline__ FragA load_a(const float* tile, int r0, int k0) {
  const int lane = threadIdx.x & 31;
  const float* p = tile + (r0 + (lane >> 2)) * S + k0 + (lane & 3);
  return split_a(p[0], p[8 * S], p[4], p[8 * S + 4]);
}

// B(k, n) = X[n0 + n][k0 + k] of a row-major tile X (row stride S): the
// B operand of A X^T, reduction along X's rows.  Banks 4 g + t.
template <int S>
__device__ __forceinline__ FragB load_b_nk(const float* tile, int n0,
                                           int k0) {
  const int lane = threadIdx.x & 31;
  const float* p = tile + (n0 + (lane >> 2)) * S + k0 + (lane & 3);
  FragB f;
  split(p[0], f.hi[0], f.lo[0]);
  split(p[4], f.hi[1], f.lo[1]);
  return f;
}

// B(k, n) = X[k0 + k][n0 + n] of a row-major tile X, k in the permuted
// order of acc_to_a (k-position t is row 2t, t + 4 is row 2t + 1): the B
// operand of C X, reduction down X's columns.  Lane (g, t) reads words
// 2t S + g and (2t + 1) S + g: banks 8t + g and 8t + 4 + g.
template <int S>
__device__ __forceinline__ FragB load_b_kn(const float* tile, int k0,
                                           int n0) {
  const int lane = threadIdx.x & 31;
  const float* p = tile + (k0 + 2 * (lane & 3)) * S + n0 + (lane >> 2);
  FragB f;
  split(p[0], f.hi[0], f.lo[0]);
  split(p[S], f.hi[1], f.lo[1]);
  return f;
}

// The A operand of a k-step from a 16 x 8 accumulator, in the permuted
// k order load_b_kn reads.
__device__ __forceinline__ FragA acc_to_a(const float (&c)[4]) {
  return split_a(c[0], c[2], c[1], c[3]);
}

// ------------------------------------------------------------- cp.async
// 16 bytes global -> shared, bypassing L1; zeros when !valid (src is
// then not read, but must still be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   hopper::smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   hopper::smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [row0, row0 + R) of a contiguous fp32 [B, S, heads, D] tensor
// (batch and head offsets applied to src; rs = heads * D floats) into a
// padded row-major tile of row stride D + 4, 16 bytes a copy, zeros past
// S.  NT threads share the copies.
template <int D, int R, int NT>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long rs, int row0, int S) {
  constexpr int C = D / 4;  // 16-byte pieces a row
  for (int i = threadIdx.x; i < R * C; i += NT) {
    const int r = i / C, c = i % C;
    const bool ok = row0 + r < S;
    cp_async16(dst + r * (D + 4) + 4 * c,
               src + (ok ? (long)(row0 + r) * rs : 0) + 4 * c, ok);
  }
}

}  // namespace tf32
