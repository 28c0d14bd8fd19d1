// Shared helpers of the tensor-core kernels that keep float32 accuracy
// (fused_linear.cu's gemm_tc_kernel and dwda_kernel, fused_attention.cu's
// forward and backward): cp.async copies into shared memory, and 3xTF32
// products on mma.sync with three fragment readers: mma_tf32x3 (both
// operands with the reduction as their slow axis), mma_nt16 (both with it
// contiguous) and mma_nn16 (A with it contiguous, B with it slow). The
// attention forward keeps q's split fragments in registers and reads its
// other operands in mma_nt16's and mma_nn16's slots with its own loops,
// around mma_step_sum.
//
// 3xTF32: each f32 operand value v is split as hi = rna(v), lo = rna(v − hi),
// both TF32 values (hi + lo is v within 2^-22·|v|), and mma.sync m16n8k8
// (tf32 in, f32 accumulate) sums lo·hi + hi·lo + hi·hi; lo·lo (about 2^-22
// relative) is dropped. A value that is already a TF32 value (a widened
// bf16) has lo = 0, and one product (hi·hi) is then exact: the kSplit =
// false forms below issue only that one.
//
// mma.sync adds into its f32 accumulator by truncation (round toward
// zero), so a long chain of MMAs into one accumulator drifts toward zero
// by about half an ulp an MMA. So every reader below sums as step sums:
// each MMA step's products go into a fresh partial sum, which is then
// added to the running sum with a round-to-nearest add, and the truncation
// acts on 8-term partials only.
//
// Fragment layouts (PTX ISA, mma.m16n8k8 .tf32): lane (g, t) = (lane / 4,
// lane % 4) holds A (16 x 8) elements (g, t), (g + 8, t), (g, t + 4),
// (g + 8, t + 4); B (8 x 8) elements (t, g), (t + 4, g); C (16 x 8)
// elements (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// cvt.rna.tf32.f32's rounding (to nearest, ties away from zero; the same
// bits for finite values) as two integer operations on the bits.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

// v = hi + lo, each a tf32 value (lo: the rounding of what hi left).
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

// kSplit: hi and lo of v; else v's own bits (a TF32 value) and lo unused.
template <bool kSplit>
__device__ __forceinline__ void split_or_keep(float v, uint32_t& hi,
                                              uint32_t& lo) {
  if (kSplit) {
    split_tf32(v, hi, lo);
  } else {
    hi = __float_as_uint(v);
    lo = 0u;
  }
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One MMA step of one tile as a step sum: lo·hi, hi·lo and hi·hi (kSplit;
// else hi·hi) into a fresh partial, then acc += partial rounded to nearest.
template <bool kSplit>
__device__ __forceinline__ void mma_step_sum(float (&acc)[4],
                                             const uint32_t (&a_hi)[4],
                                             const uint32_t (&a_lo)[4],
                                             const uint32_t (&b_hi)[2],
                                             const uint32_t (&b_lo)[2]) {
  float part[4] = {};
  if (kSplit) {
    mma_tf32(part, a_lo, b_hi);
    mma_tf32(part, a_hi, b_lo);
  }
  mma_tf32(part, a_hi, b_hi);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] = __fadd_rn(acc[e], part[e]);
}

// kSteps MMA steps (8 reduction rows each) of a warp's 32 x 16 output of
// C = Aᵀ·B where both operands have the reduction axis m as their slow
// axis: C[a][b] += Σ_m A[m][a] · B[m][b], sa = A[m][warp's 32 columns]
// (row stride kLdA), sb = B[m][warp's 16 columns] (row stride kLdB); with
// both strides 8 mod 32 words every fragment load is free of bank
// conflicts. 3xTF32 (kSplit): per step lo·hi, hi·lo, hi·hi; else hi·hi;
// as step sums (mma_step_sum), one fresh partial a tile.
// Output rows and columns are permuted so a thread reads its A fragments
// as two float4s and its B fragments as two float2s a step (row slot r of
// m16 tile i is row 4·(r % 8) + 2·i + r / 8 of the 32, column slot c of n8
// tile j is column 2·c + j of the 16; the sum is unchanged): acc[i][j] is
// m16 tile i, n8 tile j, and lane (g, t) owns rows 4g..4g+3 and columns
// 4t..4t+3 of the warp's tile, element (4g + r, 4t + c) in
// acc[r >> 1][c & 1][2 * (r & 1) + (c >> 1)].
template <int kSteps, int kLdA, int kLdB, bool kSplit = true>
__device__ __forceinline__ void mma_tf32x3(float (&acc)[2][2][4],
                                           const float* sa, const float* sb,
                                           int g, int t) {
  // Step sums hold a partial a tile: unrolled, this loop spilled
  // registers in the attention's key pass.
#pragma unroll 1
  for (int ks = 0; ks < kSteps; ++ks) {
    const float* pa = sa + (8 * ks + t) * kLdA + 4 * g;
    const float4 a0 = *(const float4*)pa;              // m = t
    const float4 a1 = *(const float4*)(pa + 4 * kLdA);  // m = t + 4
    const float* pb = sb + (8 * ks + t) * kLdB + 2 * g;
    const float2 b0 = *(const float2*)pb;
    const float2 b1 = *(const float2*)(pb + 4 * kLdB);
    // A fragment of tile i: rows (g, g + 8) -> 4g + 2i + (0, 1); cols t, t+4.
    uint32_t a[2][2][4];  // [hi, lo][tile][fragment]
    split_or_keep<kSplit>(a0.x, a[0][0][0], a[1][0][0]);
    split_or_keep<kSplit>(a0.y, a[0][0][1], a[1][0][1]);
    split_or_keep<kSplit>(a1.x, a[0][0][2], a[1][0][2]);
    split_or_keep<kSplit>(a1.y, a[0][0][3], a[1][0][3]);
    split_or_keep<kSplit>(a0.z, a[0][1][0], a[1][1][0]);
    split_or_keep<kSplit>(a0.w, a[0][1][1], a[1][1][1]);
    split_or_keep<kSplit>(a1.z, a[0][1][2], a[1][1][2]);
    split_or_keep<kSplit>(a1.w, a[0][1][3], a[1][1][3]);
    // B fragment of tile j: col g -> 2g + j; rows t, t + 4.
    uint32_t b[2][2][2];  // [hi, lo][tile][fragment]
    split_or_keep<kSplit>(b0.x, b[0][0][0], b[1][0][0]);
    split_or_keep<kSplit>(b1.x, b[0][0][1], b[1][0][1]);
    split_or_keep<kSplit>(b0.y, b[0][1][0], b[1][1][0]);
    split_or_keep<kSplit>(b1.y, b[0][1][1], b[1][1][1]);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        mma_step_sum<kSplit>(acc[i][j], a[0][i], a[1][i], b[0][j], b[1][j]);
  }
}

// C[r][c] += Σ_d A[r][d]·B[c][d] over kSteps steps of 8 d, a warp's 16 x 16
// tile: sa = A's 16 rows, sb = B's 16 rows, both with d contiguous (row
// stride kLd, 8 mod 32 words). Reduction slots t and t + 4 of step ks hold
// d = 8ks + 2t and 8ks + 2t + 1 in both operands (the sum is unchanged), so
// each fragment is one float2 load, free of bank conflicts. acc[j] is n8
// tile j (columns 8j..8j+7) in mma's C layout. 3xTF32 when kSplit (per
// step lo·hi, hi·lo, hi·hi), else hi·hi, as step sums (mma_step_sum). The
// attention backward's two passes form s and dP with this function at the
// same warp, lane and fragment slot for each (row, key), so they get the
// same bits; the fused forward reads x and the blended weight with it.
template <int kSteps, int kLd, bool kSplit>
__device__ __forceinline__ void mma_nt16(float (&acc)[2][4], const float* sa,
                                         const float* sb, int g, int t) {
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
    const int d = 8 * ks + 2 * t;
    const float2 a0 = *(const float2*)(sa + g * kLd + d);
    const float2 a1 = *(const float2*)(sa + (g + 8) * kLd + d);
    const float2 b0 = *(const float2*)(sb + g * kLd + d);
    const float2 b1 = *(const float2*)(sb + (g + 8) * kLd + d);
    uint32_t a[2][4], b[2][2][2];  // [hi, lo]([tile])[fragment]
    split_or_keep<kSplit>(a0.x, a[0][0], a[1][0]);
    split_or_keep<kSplit>(a1.x, a[0][1], a[1][1]);
    split_or_keep<kSplit>(a0.y, a[0][2], a[1][2]);
    split_or_keep<kSplit>(a1.y, a[0][3], a[1][3]);
    split_or_keep<kSplit>(b0.x, b[0][0][0], b[1][0][0]);
    split_or_keep<kSplit>(b0.y, b[0][0][1], b[1][0][1]);
    split_or_keep<kSplit>(b1.x, b[0][1][0], b[1][1][0]);
    split_or_keep<kSplit>(b1.y, b[0][1][1], b[1][1][1]);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      mma_step_sum<kSplit>(acc[j], a[0], a[1], b[0][j], b[1][j]);
  }
}

// C[r][n] += Σ_c A[r][c]·B[c][n] over kSteps steps of 8 c, a warp's 16 x 16
// tile: sa = A's 16 rows (c contiguous, row stride lda, 8 mod 32 words), sb
// = B's rows from the first c (n contiguous, row stride kLdB, 4 mod 32
// words). As in mma_nt16, slots t and t + 4 hold c = 8ks + 2t and
// 8ks + 2t + 1; column slot g of n8 tile j is column 2g + j, so a B
// fragment pair is one float2 load. Every load is free of bank conflicts.
// Lane (g, t) owns rows g, g + 8 and columns 4t..4t+3: element
// (g + 8h, 4t + c) is acc[c & 1][2h + (c >> 1)]. Step sums as mma_nt16.
// The attention backward's dq = dS·k and the fused dx = g·w_eff use it.
template <int kSteps, int kLdB, bool kSplit>
__device__ __forceinline__ void mma_nn16(float (&acc)[2][4], const float* sa,
                                         int lda, const float* sb, int g,
                                         int t) {
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
    const int c = 8 * ks + 2 * t;
    const float2 a0 = *(const float2*)(sa + g * lda + c);
    const float2 a1 = *(const float2*)(sa + (g + 8) * lda + c);
    const float2 b0 = *(const float2*)(sb + c * kLdB + 2 * g);
    const float2 b1 = *(const float2*)(sb + (c + 1) * kLdB + 2 * g);
    uint32_t a[2][4], b[2][2][2];
    split_or_keep<kSplit>(a0.x, a[0][0], a[1][0]);
    split_or_keep<kSplit>(a1.x, a[0][1], a[1][1]);
    split_or_keep<kSplit>(a0.y, a[0][2], a[1][2]);
    split_or_keep<kSplit>(a1.y, a[0][3], a[1][3]);
    split_or_keep<kSplit>(b0.x, b[0][0][0], b[1][0][0]);
    split_or_keep<kSplit>(b1.x, b[0][0][1], b[1][0][1]);
    split_or_keep<kSplit>(b0.y, b[0][1][0], b[1][1][0]);
    split_or_keep<kSplit>(b1.y, b[0][1][1], b[1][1][1]);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      mma_step_sum<kSplit>(acc[j], a[0], a[1], b[0][j], b[1][j]);
  }
}

}  // namespace
