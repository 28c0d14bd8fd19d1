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
// stays exact, and the tile's scores (128 KB at S = 512 in the forward)
// stay in shared memory. K and V stream through one shared chunk of
// kChunk keys. The numerics are the JAX kernel's: float32 products and sums
// (inputs widened from bf16), the scale applied after the first product, the
// bias added, the row max guarded at -1e30 (a fully padded row becomes
// uniform, not NaN), and p/l rounded to the input type before the second
// product.
//
// Forward bound: at bert-base (64, 12, 256, 64) the work is compute, 4·S²·D
// flops a head, 0.19 ms a call at the 67 TFLOP/s float32 rate. Its products
// are float32 FMA loops from shared memory: each thread holds a 4 rows x 4
// keys register tile and reads its operands as float4, four reduction steps
// per load; rows are padded by 4 floats, which keeps float4 rows aligned and
// the loads free of bank conflicts.
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

constexpr int kThreads = 256;  // 16 x 16: ty picks rows, tx picks columns
constexpr int kFwdRows = 64;   // forward: query rows per block (4 per ty)
constexpr int kChunk = 64;     // keys per shared K/V chunk (4 per tx)
constexpr int kMaxD = 128;     // head dim: 4 or 8 columns per tx
constexpr int kPad = 4;        // floats of padding per shared row
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

__device__ __forceinline__ const float4& f4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void fma4(float& acc, const float4& a,
                                     const float4& b) {
  acc += a.x * b.x;
  acc += a.y * b.y;
  acc += a.z * b.z;
  acc += a.w * b.w;
}

__device__ __forceinline__ void axpy4(float* acc, float p, const float4& v) {
  acc[0] += p * v.x;
  acc[1] += p * v.y;
  acc[2] += p * v.z;
  acc[3] += p * v.w;
}

// rows x D4 of src (row stride D, rows from row0) into dst (row stride ldd),
// widened to float; rows past S and columns past D read as 0.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ldd, const T* src,
                                          int row0, int rows, int S, int D,
                                          int D4) {
  for (int idx = threadIdx.x; idx < rows * D4; idx += kThreads) {
    const int r = idx / D4, d = idx - r * D4;
    const int g = row0 + r;
    dst[r * ldd + d] =
        (g < S && d < D) ? to_f(src[(long long)g * D + d]) : 0.f;
  }
}

// out[r][c0 + c] = a_r · b_c for the block's 16·RPT rows a (stride ldd)
// against one chunk of kChunk rows b (stride ldd), then scaled and biased
// when `scale_bias`. Thread (ty, tx) owns rows ty·RPT.. and keys tx + 16j.
// Columns past S are not written.
template <int RPT>
__device__ __forceinline__ void tile_dots(const float* a, const float* b,
                                          int ldd, int D4, float* out,
                                          int lds, int c0, int S,
                                          bool scale_bias, float scale,
                                          const float* bias) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[RPT][4] = {};
  for (int d = 0; d < D4; d += 4) {
    float4 av[RPT], bv[4];
#pragma unroll
    for (int i = 0; i < RPT; ++i) av[i] = f4(a + (ty * RPT + i) * ldd + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = f4(b + (tx + 16 * j) * ldd + d);
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) fma4(acc[i][j], av[i], bv[j]);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = c0 + tx + 16 * j;
    if (c >= S) continue;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      float s = acc[i][j];
      if (scale_bias) {
        s *= scale;
        if (bias != nullptr) s += bias[c];
      }
      out[(ty * RPT + i) * lds + c] = s;
    }
  }
}

// acc[i][·] += Σ_c p[row i][c0 + c] · v[c][d] over one chunk (v rows of
// stride ldd, c < cn; p zero past S). Thread (ty, tx) owns rows ty·RPT..
// and columns tx·4 + 64jj.
template <int RPT>
__device__ __forceinline__ void accumulate_pv(float (*acc)[8],
                                              const float* p, int lds,
                                              int c0, int cn, const float* v,
                                              int ldd, int D4) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  for (int c = 0; c < cn; c += 4) {
    float4 pv[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) pv[i] = f4(p + (ty * RPT + i) * lds + c0 + c);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float* vrow = v + (c + k) * ldd;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int d = tx * 4 + 64 * jj;
        if (d >= D4) continue;
        const float4 vv = f4(vrow + d);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const float pk = k == 0 ? pv[i].x : k == 1 ? pv[i].y
                         : k == 2 ? pv[i].z : pv[i].w;
          axpy4(acc[i] + 4 * jj, pk, vv);
        }
      }
    }
  }
}

// Writes acc (scaled) as rows r0 + ty·RPT.. of a (S, D) output.
template <typename T, int RPT>
__device__ __forceinline__ void store_rows(T* out, const float (*acc)[8],
                                           int r0, int S, int D,
                                           float scale) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = r0 + ty * RPT + i;
    if (r >= S) continue;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = tx * 4 + 64 * jj + e;
        if (d < D) out[(long long)r * D + d] = from_f<T>(acc[i][4 * jj + e] * scale);
      }
  }
}

// s[r][:S] <- exp(s - max(max_c s, -1e30)) for `rows` rows; the row sums go
// to `lsum`. One warp per row, fixed-order sums.
__device__ __forceinline__ void softmax_rows(float* s, int lds, int S,
                                             int rows, float* lsum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < rows; r += kThreads / 32) {
    float* row = s + r * lds;
    float m = -INFINITY;
    for (int c = lane; c < S; c += 32) m = fmaxf(m, row[c]);
    m = fmaxf(warp_max(m), kGuard);
    float l = 0.f;
    for (int c = lane; c < S; c += 32) {
      const float e = expf(row[c] - m);
      row[c] = e;
      l += e;
    }
    l = warp_sum(l);
    if (lane == 0) lsum[r] = l;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ bias,
                T* __restrict__ o, int H, int S, int D, int Sp, float scale) {
  extern __shared__ float4 smem4[];
  const int D4 = (D + 3) & ~3, ldd = D4 + kPad, lds = Sp + kPad;
  float* sq = reinterpret_cast<float*>(smem4);  // kFwdRows x ldd
  float* skv = sq + kFwdRows * ldd;             // kChunk x ldd
  float* ss = skv + kChunk * ldd;               // kFwdRows x lds
  __shared__ float lsum[kFwdRows];
  const int r0 = blockIdx.x * kFwdRows, h = blockIdx.y, b = blockIdx.z;
  const long long head = ((long long)b * H + h) * S * D;
  const float* brow = bias == nullptr ? nullptr : bias + (long long)b * S;

  load_rows(sq, ldd, q + head, r0, kFwdRows, S, D, D4);
  for (int c0 = 0; c0 < S; c0 += kChunk) {
    __syncthreads();  // the previous chunk is consumed (and sq is loaded)
    load_rows(skv, ldd, k + head, c0, kChunk, S, D, D4);
    __syncthreads();
    tile_dots<4>(sq, skv, ldd, D4, ss, lds, c0, S, true, scale, brow);
  }
  __syncthreads();
  softmax_rows(ss, lds, S, kFwdRows, lsum);
  __syncthreads();
  for (int idx = threadIdx.x; idx < kFwdRows * Sp; idx += kThreads) {
    const int r = idx / Sp, c = idx - r * Sp;
    ss[r * lds + c] = c < S ? round_to<T>(ss[r * lds + c] / lsum[r]) : 0.f;
  }

  float acc[4][8] = {};
  for (int c0 = 0; c0 < S; c0 += kChunk) {
    __syncthreads();
    load_rows(skv, ldd, v + head, c0, kChunk, S, D, D4);
    __syncthreads();
    accumulate_pv<4>(acc, ss, lds, c0, min(kChunk, S - c0), skv, ldd, D4);
  }
  store_rows<T, 4>(o + head, acc, r0, S, D, 1.f);
}

inline int padded(int S) { return (S + kChunk - 1) / kChunk * kChunk; }
inline int pad4(int D) { return (D + 3) & ~3; }

template <typename T>
int launch_forward(const void* q, const void* k, const void* v,
                   const float* bias, void* o, int B, int H, int S, int D,
                   float scale, cudaStream_t s) {
  const int Sp = padded(S), ldd = pad4(D) + kPad;
  const size_t bytes = sizeof(float) *
      (size_t)((kFwdRows + kChunk) * ldd + kFwdRows * (Sp + kPad));
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kFwdRows - 1) / kFwdRows, H, B);
  attn_fwd_kernel<T><<<grid, kThreads, bytes, s>>>(
      (const T*)q, (const T*)k, (const T*)v, bias, (T*)o, H, S, D, Sp, scale);
  return (int)cudaGetLastError();
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
  if (D > kMaxD) return (int)cudaErrorInvalidValue;
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
