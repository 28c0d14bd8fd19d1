// Fused short-sequence multi-head attention, forward and backward:
//   o = softmax(q·kᵀ·scale + bias)·v   per (batch, head), q, k, v (B, H, S, D)
// with an optional additive float32 key-padding bias (B, 1, 1, S).
//
// Replaces the Pallas TPU kernels atq_tpu/ops/fused_attention.py:_fwd_kernel
// (through _fused_fwd) and :_bwd_kernel (through _fused_bwd). Those keep one
// head's whole (S, S) float32 score tile in VMEM: 256 KB at S = 256, more
// than one Hopper block's 227 KB of shared memory. So a block here takes a
// tile of query rows (64 in the forward, 32 in the backward, which holds two
// score tiles) against all S keys: the softmax still sees whole rows and
// stays exact, and p can be rounded to the input type before the second
// product, as the JAX kernel does (a running softmax could not). The
// numerics are the JAX kernel's: float32 products and sums (inputs widened
// from bf16), the scale applied after the first product, the bias added,
// the row max guarded at -1e30 (a fully padded row becomes uniform, not
// NaN), and p = e / l rounded to the input type before the second product.
//
// Forward, attn_fwd_kernel, one launch: a block of 256 threads (8 warps)
// takes 64 query rows of one head (grid (ceil(S/64), H, B): 3,072 blocks at
// bert-base) and all S keys, in three phases:
//   1. s = q·kᵀ·scale + bias for the tile's whole rows, into shared memory.
//      Each warp splits its 16 rows of q into TF32 hi and lo once, into
//      registers; K comes in chunks of 64 keys, and warp (wr, wc) forms
//      rows 16·wr.. x keys 32·wc.. of each chunk (mma_step_sum, the
//      fragment slots of mma_nt16), keeping each row's running max.
//   2. the softmax by warps over whole rows (8 rows a warp, 4 at a time, a
//      row's values in registers): m = max(rowmax(s), -1e30) from phase
//      1's maxima, e = exp(s − m), l = Σ e, p = e / l (the IEEE quotient,
//      by one reciprocal a row and Markstein's correction) rounded to the
//      input type, 0 for keys past S.
//   3. o = p·v: V in chunks of 64 keys; warp (rh, ch, kh) forms rows
//      32·rh.. (two m16 tiles) x columns (DC / 2)·ch.. (the fragment slots
//      of mma_nn16) over keys 32·kh.. of each chunk, so that each split
//      operand feeds more MMAs; the two key halves' sums are added at the
//      end, and o is written rounded to the input type.
// q, the K chunks and the V chunks pass through one 2-stage ring of 16-byte
// cp.async copies: the next item is in flight while this one computes (the
// first V chunk during the softmax). Only the MMA steps that D reaches run
// in phase 1, and only those that a short last chunk's keys reach in phase
// 3; key tiles past S are skipped. A chunk that needs none of these guards
// takes a path without branches between its MMA steps, so that their MMAs
// overlap. Shared rows are padded to 8 mod 32 words (V: 4 mod 32), which
// keeps every fragment load and score store free of bank conflicts. Each
// o element is summed by one warp pair in a fixed order, so a launch
// repeats bit for bit.
//
// Forward bound at bert-base (64, 12, 256, 64) f32: the two products as
// three TF32 products each, 3·4·S²·D·B·H = 38.7 GFLOP, 0.078 ms at 495
// TFLOP/s, against 4·B·H·S·D·4 = 201 MB (q, k, v read; o written), 0.060 ms
// at 3.35 TB/s: operations bound it.
//
// Backward, in two launches on the tensor cores, without float atomics:
//   1. attn_bwd_rows_kernel, per 32 query rows against all S keys:
//      s = q·kᵀ·scale + bias and dP = dO·vᵀ for the tile's whole rows in
//      shared memory, m = max(rowmax(s), -1e30), l = Σ exp(s − m),
//      p32 = exp(s − m) / l, delta = rowsum(dP·p32), dS = p32·(dP − delta)
//      rounded to the input type, and dq = dS·k·scale. It writes dq and
//      three floats a row, (m, l, delta), in a (B, H, S, 4) buffer (the
//      fourth float keeps rows 16-byte aligned); P and dS never leave
//      shared memory.
//   2. attn_bwd_keys_kernel, per 64 keys, walking the query rows 32 at a
//      time in order: s and dP again, by the same device function at the
//      same warp, lane and fragment slot as pass 1 (so the same bits),
//      p32 = exp(s − m) / l from the stored m and l (pass 1's bits),
//      p = p32 and dS = p32·(dP − delta) rounded to the input type, then
//      dv += pᵀ·dO and dk += dSᵀ·q (dk scaled at the end). p and dS go from
//      the accumulators through padded shared tiles; q, dO and the row
//      statistics of the next step are in flight (a 2-stage ring of 16-byte
//      cp.async copies) while a step computes.
// Each dq, dk and dv element is summed by one block in a fixed order, so a
// launch repeats bit for bit. Recomputing s and dP in pass 2 makes the
// work 7 products of S²·D multiply-adds a head in place of the function's
// 5, and saves the 2·B·H·S² elements of P and dS written and read back.
//
// Products: 3xTF32 mma.sync m16n8k8 (tf32x3.cuh): hi = rna(v),
// lo = rna(v − hi), lo·hi + hi·lo + hi·hi in f32 accumulators, so the
// float32 path keeps float32 accuracy. Each MMA step's products form a
// fresh partial that joins the running sum by a round-to-nearest add, as
// mma.sync's own accumulation truncates toward zero. For bf16 inputs every operand (q,
// k, v, dO, the rounded p and dS) is a TF32 value, and that instantiation
// issues one exact TF32 product. s and dP have both operands K-major (d
// contiguous) and use mma_nt16; dq = dS·k reads k MN-major (mma_nn16); dv
// and dk reduce over the query rows, the slow axis of both operands, which
// is dwda_kernel's G = gᵀ·x form (mma_tf32x3). Shared rows are padded to 8
// mod 32 words (k staged for dq: 4 mod 32), which keeps every fragment load
// free of bank conflicts. D is padded with zeros to DC = 64 or 128 (a
// template parameter); keys and rows past S are masked (p = dS = 0).
//
// Backward bound at bert-base (64, 12, 256, 64) f32: the function's five
// products as three TF32 products each, 3·10·S²·D·B·H = 96.6 GFLOP, 0.195 ms
// at 495 TFLOP/s, against 7·B·H·S·D·4 = 352 MB (q, k, v, dO read; dq, dk, dv
// written), 0.105 ms at 3.35 TB/s: operations bound it.
//
// Shared memory (floats; ld = DC + 8, lds = S padded to 64, + 8):
//   forward: 64·lds + 2·64·ld, and 512 bytes of row maxima: 104,960 bytes
//            at S = 256, D = 64 (2 blocks an SM); 170,496 at S = 512,
//            D = 64; 203,264 at S = 512, D = 128;
//   pass 1: (2·32 + 64)·ld + 2·32·lds: 104,448 bytes at S = 256, D = 64
//           (2 blocks an SM); 202,752 at S = 512, D = 128;
//   pass 2: 2·64·ld + 2·(2·32·ld + 128) + 2·32·72 + 64: 93,440 bytes at D = 64
//           (2 blocks an SM), 158,976 at D = 128; S does not enter.
// All within the 227 KB a block may take.
// S <= 512 and D <= 128; the wrapper raises outside that range.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tf32x3.cuh"  // cp.async, the TF32 split, the fragment readers

namespace {

constexpr int kThreads = 256;  // 8 warps, every kernel here
constexpr int kMaxS = 512;     // sequence length
constexpr int kMaxD = 128;     // head dim
constexpr float kGuard = -1e30f;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// x rounded to T and widened back: the JAX kernel's `.astype(q.dtype)`.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// ---------------------------------------------------------------------------
// Backward: two launches on the tensor cores (3xTF32 mma.sync, tf32x3.cuh).
// ---------------------------------------------------------------------------

namespace bwd {

constexpr int kRows = 32;    // query rows: a pass-1 block, a pass-2 step
constexpr int kKeys = 64;    // keys: a pass-1 chunk, a pass-2 block
constexpr int kWarps = kThreads / 32;
constexpr int kLdP = kKeys + 8;  // the p and dS tiles' stride, 8 mod 32

// The score of one (row, key) from its q·k sum, as the JAX kernel forms
// it: (q·kᵀ)·scale + bias, two roundings. Intrinsics, so that no FMA
// contraction can make the two passes' scores differ.
__device__ __forceinline__ float score(float qk, float scale, float b) {
  return __fadd_rn(__fmul_rn(qk, scale), b);
}

// p32 from the row's max m and sum l: exp(s − m) / l.
__device__ __forceinline__ float softmax_p(float s, float m, float l) {
  return __fdiv_rn(expf(__fsub_rn(s, m)), l);
}

// dS before its rounding to the input type: p32 · (dP − delta).
__device__ __forceinline__ float ds_value(float p32, float dp, float delta) {
  return __fmul_rn(p32, __fsub_rn(dp, delta));
}

// Rows [r0, r0 + rows) of a (S, D) row-major head into dst (row stride
// ld), widened to float; rows past S and columns D..DC - 1 read as 0.
// vec (float, D % 4 == 0, 16-byte aligned): 16-byte cp.async copies, which
// land by the caller's cp_async_wait; else plain loads and stores.
template <typename T, int DC>
__device__ __forceinline__ void stage_rows(float* dst, int ld, const T* src,
                                           int r0, int rows, int S, int D,
                                           bool vec) {
  if constexpr (std::is_same<T, float>::value) {
    if (vec) {
      constexpr int kChunks = DC / 4;
      for (int idx = threadIdx.x; idx < rows * kChunks; idx += kThreads) {
        const int r = idx / kChunks, c = 4 * (idx - r * kChunks);
        const int g = r0 + r;
        const int bytes = g < S ? 4 * min(max(D - c, 0), 4) : 0;
        cp_async(dst + r * ld + c,
                 bytes ? src + (long long)g * D + c : src, bytes);
      }
      return;
    }
  }
  for (int idx = threadIdx.x; idx < rows * DC; idx += kThreads) {
    const int r = idx / DC, d = idx - r * DC;
    const int g = r0 + r;
    dst[r * ld + d] =
        (g < S && d < D) ? to_f(src[(long long)g * D + d]) : 0.f;
  }
}

// Four values of one output row, scaled, to out[0..3] (columns col..col+3
// of a row of D): one 16-byte store when vec (then D % 4 == 0), else the
// columns below D one by one.
template <typename T>
__device__ __forceinline__ void store4(T* out, int col, int D,
                                       const float (&x)[4], float scale,
                                       bool vec) {
  if constexpr (std::is_same<T, float>::value) {
    if (vec) {
      if (col < D)
        *(float4*)out = make_float4(__fmul_rn(x[0], scale),
                                    __fmul_rn(x[1], scale),
                                    __fmul_rn(x[2], scale),
                                    __fmul_rn(x[3], scale));
      return;
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (col + c < D) out[c] = from_f<T>(__fmul_rn(x[c], scale));
}

// Pass 1, one block per kRows query rows against all S keys: s (then p32)
// and dP (then dS) of the tile's whole rows in shared memory, the softmax
// over whole rows, delta = rowsum(dP·p32), dS, and dq = dS·k·scale. Writes
// dq and each row's (m, l, delta); P and dS stay in shared memory.
template <typename T, int DC>
__global__ void __launch_bounds__(kThreads, DC == 64 ? 2 : 1)
attn_bwd_rows_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     const T* __restrict__ dout, T* __restrict__ dq,
                     float4* __restrict__ stats, int H, int S, int D, int Sp,
                     float scale, int vec) {
  constexpr int kLd = DC + 8, kLdN = DC + 4;
  constexpr bool kSplit = std::is_same<T, float>::value;
  constexpr int kSteps = DC / 8;
  extern __shared__ float4 smem4[];
  const int lds = Sp + 8;
  float* sq = reinterpret_cast<float*>(smem4);  // kRows x kLd
  float* sdo = sq + kRows * kLd;                // kRows x kLd
  float* sc = sdo + kRows * kLd;                // a chunk: kKeys x kLd
  float* ss = sc + kKeys * kLd;                 // kRows x lds: s, then p32
  float* sdp = ss + kRows * lds;                // kRows x lds: dP, then dS
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp & 1, wc = warp >> 1;  // rows 16·wr, 16 keys or cols
  const int r0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const long long bh = (long long)b * H + h;
  const long long head = bh * S * D;
  const float* brow = bias == nullptr ? nullptr : bias + (long long)b * S;

  stage_rows<T, DC>(sq, kLd, q + head, r0, kRows, S, D, vec);
  stage_rows<T, DC>(sdo, kLd, dout + head, r0, kRows, S, D, vec);
  // s = q·kᵀ·scale + bias into ss, then dP = dO·vᵀ into sdp, kKeys keys a
  // chunk; warp (wr, wc) forms rows 16·wr.. x keys 16·wc.. of each chunk.
  for (int which = 0; which < 2; ++which) {
    const T* src = which == 0 ? k : v;
    const float* sa = (which == 0 ? sq : sdo) + 16 * wr * kLd;
    float* out = which == 0 ? ss : sdp;
    for (int c0 = 0; c0 < S; c0 += kKeys) {
      __syncthreads();  // the previous chunk is consumed
      stage_rows<T, DC>(sc, kLd, src + head, c0, kKeys, S, D, vec);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      float acc[2][4] = {};
      mma_nt16<kSteps, kLd, kSplit>(acc, sa, sc + 16 * wc * kLd, g, t);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = c0 + 16 * wc + 8 * j + 2 * t;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float2 x = make_float2(acc[j][2 * hh], acc[j][2 * hh + 1]);
          if (which == 0) {
            x.x = score(x.x, scale,
                        brow != nullptr && col < S ? brow[col] : 0.f);
            x.y = score(x.y, scale,
                        brow != nullptr && col + 1 < S ? brow[col + 1] : 0.f);
          }
          *(float2*)(out + (16 * wr + g + 8 * hh) * lds + col) = x;
        }
      }
    }
  }
  __syncthreads();

  // One warp per row: m, l, p32, delta = rowsum(dP·p32), dS (zero past S),
  // and the row's (m, l, delta).
  for (int r = warp; r < kRows; r += kWarps) {
    float* srow = ss + r * lds;
    float* drow = sdp + r * lds;
    float m = -INFINITY;
    for (int c = lane; c < S; c += 32) m = fmaxf(m, srow[c]);
    m = fmaxf(warp_max(m), kGuard);
    float l = 0.f;
    for (int c = lane; c < S; c += 32) {
      const float e = expf(__fsub_rn(srow[c], m));
      srow[c] = e;
      l += e;
    }
    l = warp_sum(l);
    float delta = 0.f;
    for (int c = lane; c < S; c += 32) {
      const float p32 = __fdiv_rn(srow[c], l);  // softmax_p's bits
      srow[c] = p32;
      delta += drow[c] * p32;
    }
    delta = warp_sum(delta);
    for (int c = lane; c < Sp; c += 32)
      drow[c] = c < S ? round_to<T>(ds_value(srow[c], drow[c], delta)) : 0.f;
    if (lane == 0 && r0 + r < S)
      stats[bh * S + r0 + r] = make_float4(m, l, delta, 0.f);
  }

  // dq = dS·k·scale: warp (wr, wc) forms rows 16·wr.. x columns
  // (DC / 4)·wc.., kKeys keys a chunk; k is staged with stride kLdN here.
  constexpr int kPairs = DC / 64;  // 16-column pairs of n8 tiles a warp
  float acc[kPairs][2][4] = {};
  for (int c0 = 0; c0 < S; c0 += kKeys) {
    __syncthreads();
    stage_rows<T, DC>(sc, kLdN, k + head, c0, kKeys, S, D, vec);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int pr = 0; pr < kPairs; ++pr)
      mma_nn16<kKeys / 8, kLdN, kSplit>(
          acc[pr], sdp + 16 * wr * lds + c0, lds,
          sc + (DC / 4) * wc + 16 * pr, g, t);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = r0 + 16 * wr + g + 8 * hh;
    if (row >= S) continue;
#pragma unroll
    for (int pr = 0; pr < kPairs; ++pr) {
      const int col = (DC / 4) * wc + 16 * pr + 4 * t;
      const float x[4] = {acc[pr][0][2 * hh], acc[pr][1][2 * hh],
                          acc[pr][0][2 * hh + 1], acc[pr][1][2 * hh + 1]};
      store4<T>(dq + head + (long long)row * D + col, col, D, x, scale,
                vec);
    }
  }
}

// Pass 2, one block per kKeys keys, walking the query rows kRows at a time
// in order: recompute s and dP with pass 1's function, p32 from the stored
// (m, l), dS = p32·(dP − delta) rounded, then dv += pᵀ·dO and dk += dSᵀ·q
// (dwda_kernel's G = gᵀ·x form, mma_tf32x3), dk scaled at the end. q, dO
// and the stats of the next step are in flight (a 2-stage cp.async ring)
// while a step computes.
template <typename T, int DC>
__global__ void __launch_bounds__(kThreads, DC == 64 ? 2 : 1)
attn_bwd_keys_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     const T* __restrict__ dout,
                     const float4* __restrict__ stats, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int S, int D, float scale,
                     int vec) {
  constexpr int kLd = DC + 8;
  constexpr bool kSplit = std::is_same<T, float>::value;
  constexpr int kStage = 2 * kRows * kLd + 4 * kRows;  // q, dO, stats
  constexpr int kPairs = DC / 64;  // 16-column groups of dk/dv a warp
  extern __shared__ float4 smem4[];
  float* sk = reinterpret_cast<float*>(smem4);  // kKeys x kLd
  float* sv = sk + kKeys * kLd;                 // kKeys x kLd
  float* ring = sv + kKeys * kLd;               // 2 stages
  float* sp = ring + 2 * kStage;                // kRows x kLdP
  float* sds = sp + kRows * kLdP;               // kRows x kLdP
  float* skb = sds + kRows * kLdP;              // kKeys: each key's bias
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp & 1, wc = warp >> 1;  // s, dP: rows 16·wr, keys 16·wc
  const int wk = warp & 1, wd = warp >> 1;  // dk, dv: keys 32·wk, cols 16·wd
  const int k0 = blockIdx.x * kKeys, h = blockIdx.y, b = blockIdx.z;
  const long long bh = (long long)b * H + h;
  const long long head = bh * S * D;
  const float* brow = bias == nullptr ? nullptr : bias + (long long)b * S;

  // The block's keys' bias; -inf past S, where p and dS then come out 0.
  if (tid < kKeys) {
    const int c = k0 + tid;
    skb[tid] = c >= S ? -INFINITY : brow != nullptr ? brow[c] : 0.f;
  }

  stage_rows<T, DC>(sk, kLd, k + head, k0, kKeys, S, D, vec);
  stage_rows<T, DC>(sv, kLd, v + head, k0, kKeys, S, D, vec);
  const int n_steps = (S + kRows - 1) / kRows;
  auto issue = [&](int i) {  // step i's q, dO and stats into stage i % 2
    if (i < n_steps) {
      float* st = ring + (i & 1) * kStage;
      stage_rows<T, DC>(st, kLd, q + head, i * kRows, kRows, S, D, vec);
      stage_rows<T, DC>(st + kRows * kLd, kLd, dout + head, i * kRows,
                        kRows, S, D, vec);
      if (tid < kRows) {
        const int row = i * kRows + tid;
        cp_async(st + 2 * kRows * kLd + 4 * tid,
                 stats + bh * S + min(row, S - 1), row < S ? 16 : 0);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };

  float acc_v[kPairs][2][2][4] = {}, acc_k[kPairs][2][2][4] = {};
  issue(0);
  for (int i = 0; i < n_steps; ++i) {
    cp_async_wait<0>();  // step i has landed (this thread's copies)
    __syncthreads();     // everyone's; step i - 1 is done with its stage
    issue(i + 1);
    const float* sq = ring + (i & 1) * kStage;
    const float* sdo = sq + kRows * kLd;
    const float4* sst = reinterpret_cast<const float4*>(sdo + kRows * kLd);

    float s_acc[2][4] = {}, dp_acc[2][4] = {};
    mma_nt16<DC / 8, kLd, kSplit>(s_acc, sq + 16 * wr * kLd,
                                  sk + 16 * wc * kLd, g, t);
    mma_nt16<DC / 8, kLd, kSplit>(dp_acc, sdo + 16 * wr * kLd,
                                  sv + 16 * wc * kLd, g, t);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 16 * wr + g + 8 * hh;
      const bool row_ok = i * kRows + r < S;
      const float4 st = sst[r];  // (m, l, delta)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = 16 * wc + 8 * j + 2 * t;
        const float2 kb = *(const float2*)(skb + c);
        float p[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p32 =
              row_ok ? softmax_p(score(s_acc[j][2 * hh + e], scale,
                                       e ? kb.y : kb.x), st.x, st.y)
                     : 0.f;
          p[e] = round_to<T>(p32);
          ds[e] = row_ok ? round_to<T>(ds_value(
                               p32, dp_acc[j][2 * hh + e], st.z))
                         : 0.f;
        }
        const int at = r * kLdP + c;
        *(float2*)(sp + at) = make_float2(p[0], p[1]);
        *(float2*)(sds + at) = make_float2(ds[0], ds[1]);
      }
    }
    __syncthreads();  // p and dS of the step are whole
#pragma unroll
    for (int pr = 0; pr < kPairs; ++pr) {
      const int col = 16 * wd + 64 * pr;
      mma_tf32x3<kRows / 8, kLdP, kLd, kSplit>(
          acc_v[pr], sp + 32 * wk, sdo + col, g, t);
      mma_tf32x3<kRows / 8, kLdP, kLd, kSplit>(
          acc_k[pr], sds + 32 * wk, sq + col, g, t);
    }
  }

  // Lane (g, t) owns keys 32·wk + 4g + r and columns col + 4t + c.
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int key = k0 + 32 * wk + 4 * g + r;
    if (key >= S) continue;
#pragma unroll
    for (int pr = 0; pr < kPairs; ++pr) {
      const int col = 16 * wd + 64 * pr + 4 * t;
      float xv[4], xk[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        xv[c] = acc_v[pr][r >> 1][c & 1][2 * (r & 1) + (c >> 1)];
        xk[c] = acc_k[pr][r >> 1][c & 1][2 * (r & 1) + (c >> 1)];
      }
      const long long at = head + (long long)key * D + col;
      store4<T>(dv + at, col, D, xv, 1.f, vec);
      store4<T>(dk + at, col, D, xk, scale, vec);
    }
  }
}

template <int kLd>
constexpr size_t keys_smem_bytes() {
  return sizeof(float) *
         (2 * kKeys * kLd + 2 * (2 * kRows * kLd + 4 * kRows) +
          2 * kRows * kLdP + kKeys);
}

template <typename T, int DC>
int launch(const void* q, const void* k, const void* v, const float* bias,
           const void* dout, void* dq, void* dk, void* dv, float4* stats,
           int B, int H, int S, int D, float scale, cudaStream_t s) {
  constexpr int kLd = DC + 8;
  const int Sp = (S + kKeys - 1) / kKeys * kKeys;
  const auto a16 = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
  const int vec = std::is_same<T, float>::value && D % 4 == 0 && a16(q) &&
                  a16(k) && a16(v) && a16(dout) && a16(dq) && a16(dk) &&
                  a16(dv);
  const size_t rows_bytes =
      sizeof(float) * ((size_t)(2 * kRows + kKeys) * kLd +
                       (size_t)2 * kRows * (Sp + 8));
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_rows_kernel<T, DC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)rows_bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 rows_grid((S + kRows - 1) / kRows, H, B);
  attn_bwd_rows_kernel<T, DC><<<rows_grid, kThreads, rows_bytes, s>>>(
      (const T*)q, (const T*)k, (const T*)v, bias, (const T*)dout, (T*)dq,
      stats, H, S, D, Sp, scale, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  constexpr size_t keys_bytes = keys_smem_bytes<kLd>();
  err = cudaFuncSetAttribute(attn_bwd_keys_kernel<T, DC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)keys_bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 keys_grid((S + kKeys - 1) / kKeys, H, B);
  attn_bwd_keys_kernel<T, DC><<<keys_grid, kThreads, keys_bytes, s>>>(
      (const T*)q, (const T*)k, (const T*)v, bias, (const T*)dout, stats,
      (T*)dk, (T*)dv, H, S, D, scale, vec);
  return (int)cudaGetLastError();
}

}  // namespace bwd

template <typename T>
int launch_backward(const void* q, const void* k, const void* v,
                    const float* bias, const void* dout, void* dq, void* dk,
                    void* dv, float4* stats, int B, int H, int S, int D,
                    float scale, cudaStream_t s) {
  return D <= 64 ? bwd::launch<T, 64>(q, k, v, bias, dout, dq, dk, dv, stats,
                                      B, H, S, D, scale, s)
                 : bwd::launch<T, 128>(q, k, v, bias, dout, dq, dk, dv,
                                       stats, B, H, S, D, scale, s);
}

// ---------------------------------------------------------------------------
// Forward: one launch on the tensor cores (3xTF32 mma.sync, tf32x3.cuh).
// ---------------------------------------------------------------------------

namespace fwd {

constexpr int kRows = 64;              // query rows a block
constexpr int kKeys = 64;              // keys a ring item (a K or V chunk)
constexpr int kStages = 2;             // ring stages
constexpr int kWarps = kThreads / 32;  // 8
constexpr int kHalf = kKeys / 2;       // keys of a chunk a warp takes

// Phase 1 on one K chunk: the warp's 16 rows x 32 keys (four n8 tiles) of
// s = q·kᵀ·scale + bias into out (ss at the warp's rows and first key),
// and each row's running max over the keys below S into mrow[h] (rows g,
// g + 8). qf: the rows' q fragments, hi and lo, a step over d each; sk:
// the chunk's rows of the warp's keys. kFull: all four tiles below S and
// all kSteps steps, with no branch between the steps (so that their MMAs
// overlap); else only the tiles that reach below S and the steps below D.
// Either way each element sums its steps in order: the same bits.
template <bool kFull, bool kSplit, int kSteps, int kLd>
__device__ __forceinline__ void score_chunk(
    const uint32_t (&qf)[kSteps][2][4], const float* sk, float* out,
    int lds, int d_steps, float scale, const float* brow, int key0, int S,
    int g, int t, float (&mrow)[2]) {
  const int tiles = (S - key0 + 7) / 8;  // n8 tiles that reach below S
  float acc[4][4] = {};
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
    if (!kFull && ks >= d_steps) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (!kFull && j >= tiles) break;
      // B slots t, t + 4 of key g hold d = 8ks + 2t, 8ks + 2t + 1, as
      // the q fragments do (mma_nt16's order): one float2 load.
      const float2 kv =
          *(const float2*)(sk + (8 * j + g) * kLd + 8 * ks + 2 * t);
      uint32_t bh[2], bl[2];
      split_or_keep<kSplit>(kv.x, bh[0], bl[0]);
      split_or_keep<kSplit>(kv.y, bh[1], bl[1]);
      mma_step_sum<kSplit>(acc[j], qf[ks][0], qf[ks][1], bh, bl);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (!kFull && j >= tiles) break;
    const int col = key0 + 8 * j + 2 * t;
    const float b0 = brow != nullptr && col < S ? brow[col] : 0.f;
    const float b1 = brow != nullptr && col + 1 < S ? brow[col + 1] : 0.f;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float s0 = bwd::score(acc[j][2 * hh], scale, b0);
      const float s1 = bwd::score(acc[j][2 * hh + 1], scale, b1);
      *(float2*)(out + (g + 8 * hh) * lds + 8 * j + 2 * t) =
          make_float2(s0, s1);
      if (kFull || col < S) mrow[hh] = fmaxf(mrow[hh], s0);
      if (kFull || col + 1 < S) mrow[hh] = fmaxf(mrow[hh], s1);
    }
  }
}

// Phase 2: the softmax of the block's rows, warp w taking rows w, w + 8, ...
// kAt at a time (their loads, shuffles and sums interleave), a row's kVals
// · 32 values (kVals · 32 >= S) in registers: m = max(row max, -1e30) from
// phase 1's maxima (smax: each row's two warps'), e = exp(s − m), l = Σ e
// (each lane's values in order, then warp_sum's tree), p = e / l rounded to
// T, and p = 0 for keys S..Sp - 1. e / l is the IEEE quotient, as
// Markstein's correction of e·RN(1/l) gives it: one reciprocal a row and
// three operations a value, not a division.
template <typename T, int kVals>
__device__ __forceinline__ void softmax_rows(float* ss, int lds,
                                             const float* smax, int S,
                                             int Sp, int warp, int lane) {
  constexpr int kAt = kVals >= 16 ? 2 : 4;
  for (int it = 0; it < kRows / kWarps; it += kAt) {
    float* row[kAt];
    float x[kAt][kVals], m[kAt], l[kAt];
#pragma unroll
    for (int a = 0; a < kAt; ++a) {
      const int r = warp + kWarps * (it + a);
      row[a] = ss + r * lds;
      m[a] = fmaxf(fmaxf(smax[2 * r], smax[2 * r + 1]), kGuard);
      l[a] = 0.f;
#pragma unroll
      for (int i = 0; i < kVals; ++i) {
        const int c = lane + 32 * i;
        x[a][i] = c < S ? expf(__fsub_rn(row[a][c], m[a])) : 0.f;
        l[a] += x[a][i];
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)  // warp_sum, kAt rows at once
#pragma unroll
      for (int a = 0; a < kAt; ++a)
        l[a] += __shfl_xor_sync(kFull, l[a], off);
#pragma unroll
    for (int a = 0; a < kAt; ++a) {
      const float rl = __frcp_rn(l[a]);  // l >= 1: the row's largest e is 1
#pragma unroll
      for (int i = 0; i < kVals; ++i) {
        const int c = lane + 32 * i;
        const float q0 = __fmul_rn(x[a][i], rl);
        const float p = __fmaf_rn(__fmaf_rn(-q0, l[a], x[a][i]), rl, q0);
        if (c < Sp) row[a][c] = c < S ? round_to<T>(p) : 0.f;
      }
    }
  }
}

// Phase 3 on one V chunk: acc += the warp's 32 rows of p (two m16 tiles;
// pc: at the warp's first row and key, row stride lds) times the V rows of
// its kHalf keys (sv: at the first of them and the warp's first column),
// kPairs groups of 16 columns (column slot g of n8 tile j is column
// 2g + j, as in mma_nn16). kFull: all kHalf / 8 steps and all groups, with
// no branch between them; else only the steps that the keys below S reach
// and the groups below D. Either way each element sums its steps in order:
// the same bits.
template <bool kFull, bool kSplit, int kPairs, int kLdV>
__device__ __forceinline__ void pv_chunk(float (&acc)[2][kPairs][2][4],
                                         const float* pc, int lds,
                                         const float* sv, int steps,
                                         int groups, int g, int t) {
#pragma unroll
  for (int ks = 0; ks < kHalf / 8; ++ks) {
    if (!kFull && ks >= steps) break;
    const int kc = 8 * ks + 2 * t;  // slots t, t + 4: keys kc, kc + 1
    uint32_t a[2][2][4];            // [m16 tile][hi, lo][fragment]
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const float2 a0 = *(const float2*)(pc + (16 * mi + g) * lds + kc);
      const float2 a1 = *(const float2*)(pc + (16 * mi + g + 8) * lds + kc);
      split_or_keep<kSplit>(a0.x, a[mi][0][0], a[mi][1][0]);
      split_or_keep<kSplit>(a1.x, a[mi][0][1], a[mi][1][1]);
      split_or_keep<kSplit>(a0.y, a[mi][0][2], a[mi][1][2]);
      split_or_keep<kSplit>(a1.y, a[mi][0][3], a[mi][1][3]);
    }
#pragma unroll
    for (int pr = 0; pr < kPairs; ++pr) {
      if (!kFull && pr >= groups) break;
      const float* pb = sv + kc * kLdV + 16 * pr + 2 * g;
      const float2 b0 = *(const float2*)pb;
      const float2 b1 = *(const float2*)(pb + kLdV);
      uint32_t bf[2][2][2];  // [hi, lo][tile][fragment]
      split_or_keep<kSplit>(b0.x, bf[0][0][0], bf[1][0][0]);
      split_or_keep<kSplit>(b1.x, bf[0][0][1], bf[1][0][1]);
      split_or_keep<kSplit>(b0.y, bf[0][1][0], bf[1][1][0]);
      split_or_keep<kSplit>(b1.y, bf[0][1][1], bf[1][1][1]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          mma_step_sum<kSplit>(acc[mi][pr][j], a[mi][0], a[mi][1],
                               bf[0][j], bf[1][j]);
    }
  }
}

// s, the softmax and o for kRows query rows of one head against all S keys
// (the note at the top). Ring items: 0 is q, 1..n_chunks the K chunks,
// then n_chunks V chunks; item i goes to stage i % kStages.
template <typename T, int DC>
__global__ void __launch_bounds__(kThreads, DC == 64 ? 2 : 1)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ bias,
                T* __restrict__ o, int H, int S, int D, int Sp, float scale,
                int vec) {
  constexpr int kLd = DC + 8;   // q and K rows: 8 mod 32 words
  constexpr int kLdV = DC + 4;  // V rows: 4 mod 32 words (mma_nn16's B)
  constexpr int kStage = kKeys * kLd;
  constexpr bool kSplit = std::is_same<T, float>::value;
  constexpr int kSteps = DC / 8;   // MMA steps over d
  constexpr int kPairs = DC / 32;  // 16-column groups of o a warp
  extern __shared__ float4 smem4[];
  __shared__ float smax[2 * kRows];  // each row's max, from its two warps
  const int lds = Sp + 8;
  float* ss = reinterpret_cast<float*>(smem4);  // kRows x lds: s, then p
  float* ring = ss + kRows * lds;               // kStages x kStage
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const long long head = ((long long)b * H + h) * S * D;
  const float* brow = bias == nullptr ? nullptr : bias + (long long)b * S;
  const int n_chunks = Sp / kKeys;
  const int d_steps = (D + 7) / 8;  // the steps over d that D reaches

  auto issue = [&](int i) {
    float* st = ring + (i % kStages) * kStage;
    if (i == 0)
      bwd::stage_rows<T, DC>(st, kLd, q + head, r0, kRows, S, D, vec);
    else if (i <= n_chunks)
      bwd::stage_rows<T, DC>(st, kLd, k + head, (i - 1) * kKeys, kKeys, S,
                             D, vec);
    else if (i <= 2 * n_chunks)
      bwd::stage_rows<T, DC>(st, kLdV, v + head,
                             (i - 1 - n_chunks) * kKeys, kKeys, S, D, vec);
    cp_async_commit();  // an empty group past the end keeps the count
  };

  // 1. s = q·kᵀ·scale + bias: warp (wr, wc) forms rows 16·wr.. x keys
  // 32·wc.. of each chunk. The warp's 16 rows of q as TF32 fragments, hi
  // and lo, for every step over d: split once, kept in registers.
  const int wr = warp & 3, wc = warp >> 2;
  issue(0);
  issue(1);
  cp_async_wait<1>();  // q has landed; K chunk 0 is in flight
  __syncthreads();
  uint32_t qf[kSteps][2][4];  // [step][hi, lo][fragment]
  {
    const float* sq = ring + 16 * wr * kLd;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      const int d = 8 * ks + 2 * t;
      const float2 a0 = *(const float2*)(sq + g * kLd + d);
      const float2 a1 = *(const float2*)(sq + (g + 8) * kLd + d);
      split_or_keep<kSplit>(a0.x, qf[ks][0][0], qf[ks][1][0]);
      split_or_keep<kSplit>(a1.x, qf[ks][0][1], qf[ks][1][1]);
      split_or_keep<kSplit>(a0.y, qf[ks][0][2], qf[ks][1][2]);
      split_or_keep<kSplit>(a1.y, qf[ks][0][3], qf[ks][1][3]);
    }
  }
  float mrow[2] = {-INFINITY, -INFINITY};  // rows g, g + 8: running max
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<0>();  // K chunk c (item c + 1) has landed for this thread
    __syncthreads();     // for every thread; item c is consumed
    issue(c + 2);
    const int key0 = c * kKeys + 32 * wc;
    const float* sk = ring + ((c + 1) % kStages) * kStage + 32 * wc * kLd;
    float* out = ss + 16 * wr * lds + key0;
    if (S - key0 >= 32 && d_steps == kSteps)
      score_chunk<true, kSplit, kSteps, kLd>(qf, sk, out, lds, d_steps,
                                             scale, brow, key0, S, g, t,
                                             mrow);
    else
      score_chunk<false, kSplit, kSteps, kLd>(qf, sk, out, lds, d_steps,
                                              scale, brow, key0, S, g, t,
                                              mrow);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {  // the max over the quad's lanes
    mrow[hh] = fmaxf(mrow[hh], __shfl_xor_sync(kFull, mrow[hh], 1));
    mrow[hh] = fmaxf(mrow[hh], __shfl_xor_sync(kFull, mrow[hh], 2));
    if (t == 0) smax[2 * (16 * wr + g + 8 * hh) + wc] = mrow[hh];
  }
  __syncthreads();  // every score and row max is in shared memory

  // 2. The softmax over whole rows, a row's values in registers.
  if (Sp <= 64)
    softmax_rows<T, 2>(ss, lds, smax, S, Sp, warp, lane);
  else if (Sp <= 128)
    softmax_rows<T, 4>(ss, lds, smax, S, Sp, warp, lane);
  else if (Sp <= 256)
    softmax_rows<T, 8>(ss, lds, smax, S, Sp, warp, lane);
  else
    softmax_rows<T, kMaxS / 32>(ss, lds, smax, S, Sp, warp, lane);

  // 3. o = p·v: warp (rh, ch, kh) forms rows 32·rh.. x columns col0.. over
  // keys 32·kh.. of each chunk, kPairs groups of 16 columns; the two key
  // halves' sums are added at the end, o = half 0 + half 1.
  const int rh = warp & 1, ch = (warp >> 1) & 1, kh = warp >> 2;
  const int col0 = (DC / 2) * ch;
  const int groups = (D - col0 + 15) / 16;  // column groups below D
  float acc[2][kPairs][2][4] = {};
  const float* sp = ss + 32 * rh * lds + kHalf * kh;
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<0>();  // V chunk c (item n_chunks + 1 + c) has landed
    __syncthreads();     // for every thread; p is whole; last item consumed
    issue(n_chunks + 2 + c);
    const float* sv = ring + ((n_chunks + 1 + c) % kStages) * kStage +
                      kHalf * kh * kLdV + col0;
    const int keys = min(kHalf, S - c * kKeys - kHalf * kh);  // below S
    const int steps = (keys + 7) / 8;  // may be <= 0: none
    if (steps == kHalf / 8 && groups >= kPairs)
      pv_chunk<true, kSplit, kPairs, kLdV>(acc, sp + c * kKeys, lds, sv,
                                           steps, groups, g, t);
    else
      pv_chunk<false, kSplit, kPairs, kLdV>(acc, sp + c * kKeys, lds, sv,
                                            steps, groups, g, t);
  }

  // Lane (g, t) owns rows g, g + 8 of each m16 tile and columns 4t..4t+3
  // of each group: element (g + 8h, 4t + c) is acc[mi][pr][c & 1][2h +
  // (c >> 1)]. Key half 1 leaves its sums in the ring (no copy is in
  // flight any more), key half 0 adds them and writes o.
  float* part = ring;  // kRows x kLdV
  __syncthreads();     // every warp is done with the last V chunk
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 32 * rh + 16 * mi + g + 8 * hh;
#pragma unroll
      for (int pr = 0; pr < kPairs; ++pr) {
        const int col = col0 + 16 * pr + 4 * t;
        float4* at = reinterpret_cast<float4*>(part + r * kLdV + col);
        const float4 x = make_float4(
            acc[mi][pr][0][2 * hh], acc[mi][pr][1][2 * hh],
            acc[mi][pr][0][2 * hh + 1], acc[mi][pr][1][2 * hh + 1]);
        if (kh == 1) *at = x;
      }
    }
  __syncthreads();
  if (kh == 1) return;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 32 * rh + 16 * mi + g + 8 * hh;
      if (r0 + r >= S) continue;
#pragma unroll
      for (int pr = 0; pr < kPairs; ++pr) {
        const int col = col0 + 16 * pr + 4 * t;
        const float4 y =
            *reinterpret_cast<const float4*>(part + r * kLdV + col);
        const float x[4] = {
            __fadd_rn(acc[mi][pr][0][2 * hh], y.x),
            __fadd_rn(acc[mi][pr][1][2 * hh], y.y),
            __fadd_rn(acc[mi][pr][0][2 * hh + 1], y.z),
            __fadd_rn(acc[mi][pr][1][2 * hh + 1], y.w)};
        bwd::store4<T>(o + head + (long long)(r0 + r) * D + col, col, D, x,
                       1.f, vec);
      }
    }
}

template <typename T, int DC>
int launch(const void* q, const void* k, const void* v, const float* bias,
           void* o, int B, int H, int S, int D, float scale, cudaStream_t s) {
  const int Sp = (S + kKeys - 1) / kKeys * kKeys;
  const auto a16 = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
  const int vec = std::is_same<T, float>::value && D % 4 == 0 && a16(q) &&
                  a16(k) && a16(v) && a16(o);
  const size_t bytes = sizeof(float) * ((size_t)kRows * (Sp + 8) +
                                        (size_t)kStages * kKeys * (DC + 8));
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_kernel<T, DC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kRows - 1) / kRows, H, B);
  attn_fwd_kernel<T, DC><<<grid, kThreads, bytes, s>>>(
      (const T*)q, (const T*)k, (const T*)v, bias, (T*)o, H, S, D, Sp, scale,
      vec);
  return (int)cudaGetLastError();
}

}  // namespace fwd

template <typename T>
int launch_forward(const void* q, const void* k, const void* v,
                   const float* bias, void* o, int B, int H, int S, int D,
                   float scale, cudaStream_t s) {
  return D <= 64 ? fwd::launch<T, 64>(q, k, v, bias, o, B, H, S, D, scale, s)
                 : fwd::launch<T, 128>(q, k, v, bias, o, B, H, S, D, scale,
                                       s);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, k, v, o share it). q, k, v, o: (B, H, S,
// D) contiguous; bias: (B, S) float32 or null. Launches on `stream` and does
// not synchronise. Returns the cudaError_t of the launch.
extern "C" int atq_attention_forward(int device, int dtype, const void* q,
                                     const void* k, const void* v,
                                     const float* bias, void* o, int B, int H,
                                     int S, int D, float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (D > kMaxD || S > kMaxS) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 1 ? launch_forward<__nv_bfloat16>(q, k, v, bias, o, B, H, S,
                                                    D, scale, s)
                    : launch_forward<float>(q, k, v, bias, o, B, H, S, D,
                                            scale, s);
}

// As the forward, plus dout (B, H, S, D) and the outputs dq, dk, dv;
// stats is (B, H, S, 4) float32 scratch: each query row's (m, l, delta),
// written by the first launch and read by the second.
extern "C" int atq_attention_backward(int device, int dtype, const void* q,
                                      const void* k, const void* v,
                                      const float* bias, const void* dout,
                                      void* dq, void* dk, void* dv,
                                      void* stats, int B, int H, int S,
                                      int D, float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (D > kMaxD) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float4* st = (float4*)stats;
  return dtype == 1
             ? launch_backward<__nv_bfloat16>(q, k, v, bias, dout, dq, dk, dv,
                                              st, B, H, S, D, scale, s)
             : launch_backward<float>(q, k, v, bias, dout, dq, dk, dv, st, B,
                                      H, S, D, scale, s);
}
