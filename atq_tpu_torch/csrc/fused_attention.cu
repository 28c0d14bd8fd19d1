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
// Backward, in two launches and without float atomics:
//   1. per query tile: recompute the scores, p32 = softmax, dP = dO·vᵀ
//      (float32), dS = p32·(dP − rowsum(dP·p32)) rounded to the input type;
//      write P (p32 rounded to the input type) and dS to device memory, and
//      dq = dS·k·scale for the tile.
//   2. per tile of 32 keys: dv = Pᵀ·dO and dk = dSᵀ·q·scale, summing over
//      every query row in a fixed order.
// Writing P and dS costs 2·B·H·S² elements of traffic, but each dk/dv sum then
// runs in one block in a fixed order, and the rounded P and dS are exactly the
// operands the JAX kernel feeds its last three products.
//
// Bound: at bert-base (64, 12, 256, 64) the work is compute: 4·S²·D flops a
// head forward, 10·S²·D backward, at the 67 TFLOP/s float32 rate 0.19 ms and
// 0.48 ms a call. The products are float32 FMA loops from shared memory
// (float32 has no tensor-core path that keeps the JAX kernel's numerics).
// Each thread holds a register tile (4 rows x 4 keys in the forward, 2 x 4 in
// the backward) and reads its operands as float4, four reduction steps per
// load, so shared-memory bandwidth no longer sets the rate; rows are padded
// by 4 floats, which keeps float4 rows aligned and the loads free of bank
// conflicts. Pipelined loads (cp.async/TMA) are later work.
// S <= 512 and D <= 128; the wrapper raises outside that range.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16: ty picks rows, tx picks columns
constexpr int kFwdRows = 64;   // forward: query rows per block (4 per ty)
constexpr int kBwdRows = 32;   // backward pass 1: query rows (2 per ty)
constexpr int kChunk = 64;     // keys per shared K/V chunk (4 per tx)
constexpr int kKeys = 32;      // backward pass 2: keys per block (2 per ty)
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

// Pass 1 of the backward: P, dS and dq for one tile of kBwdRows query rows.
template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_bwd_rows_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     const T* __restrict__ dout, T* __restrict__ dq,
                     T* __restrict__ p_out, T* __restrict__ ds_out, int H,
                     int S, int D, int Sp, float scale) {
  extern __shared__ float4 smem4[];
  const int D4 = (D + 3) & ~3, ldd = D4 + kPad, lds = Sp + kPad;
  float* sq = reinterpret_cast<float*>(smem4);  // kBwdRows x ldd
  float* sdo = sq + kBwdRows * ldd;             // kBwdRows x ldd
  float* skv = sdo + kBwdRows * ldd;            // kChunk x ldd
  float* ss = skv + kChunk * ldd;               // kBwdRows x lds: s, then p32
  float* sdp = ss + kBwdRows * lds;             // kBwdRows x lds: dP, then dS
  __shared__ float lsum[kBwdRows];
  const int r0 = blockIdx.x * kBwdRows, h = blockIdx.y, b = blockIdx.z;
  const long long bh = (long long)b * H + h;
  const long long head = bh * S * D;
  const long long sq_base = bh * S * S;
  const float* brow = bias == nullptr ? nullptr : bias + (long long)b * S;

  load_rows(sq, ldd, q + head, r0, kBwdRows, S, D, D4);
  load_rows(sdo, ldd, dout + head, r0, kBwdRows, S, D, D4);
  for (int c0 = 0; c0 < S; c0 += kChunk) {
    __syncthreads();
    load_rows(skv, ldd, k + head, c0, kChunk, S, D, D4);
    __syncthreads();
    tile_dots<2>(sq, skv, ldd, D4, ss, lds, c0, S, true, scale, brow);
  }
  for (int c0 = 0; c0 < S; c0 += kChunk) {
    __syncthreads();
    load_rows(skv, ldd, v + head, c0, kChunk, S, D, D4);
    __syncthreads();
    tile_dots<2>(sdo, skv, ldd, D4, sdp, lds, c0, S, false, 1.f, nullptr);
  }
  __syncthreads();
  softmax_rows(ss, lds, S, kBwdRows, lsum);
  __syncthreads();

  // One warp per row: p32, P, the row sum of dP·p32, dS (zero past S).
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < kBwdRows; r += kThreads / 32) {
    const int g = r0 + r;
    float* prow = ss + r * lds;
    float* drow = sdp + r * lds;
    const float l = lsum[r];
    float t = 0.f;
    for (int c = lane; c < S; c += 32) {
      const float p32 = prow[c] / l;
      prow[c] = p32;
      t += drow[c] * p32;
      if (g < S) p_out[sq_base + (long long)g * S + c] = from_f<T>(p32);
    }
    t = warp_sum(t);
    for (int c = lane; c < Sp; c += 32) {
      const float ds = c < S ? round_to<T>(prow[c] * (drow[c] - t)) : 0.f;
      drow[c] = ds;
      if (g < S && c < S)
        ds_out[sq_base + (long long)g * S + c] = from_f<T>(ds);
    }
  }

  // dq = dS·k·scale.
  float acc[2][8] = {};
  for (int c0 = 0; c0 < S; c0 += kChunk) {
    __syncthreads();
    load_rows(skv, ldd, k + head, c0, kChunk, S, D, D4);
    __syncthreads();
    accumulate_pv<2>(acc, sdp, lds, c0, min(kChunk, S - c0), skv, ldd, D4);
  }
  store_rows<T, 2>(dq + head, acc, r0, S, D, scale);
}

// Pass 2 of the backward: dv = Pᵀ·dO and dk = dSᵀ·q·scale for kKeys keys,
// over every query row in order. P and dS are staged transposed (key-major)
// so each thread reads four query rows of them as one float4.
template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_bwd_keys_kernel(const T* __restrict__ q, const T* __restrict__ dout,
                     const T* __restrict__ p_in, const T* __restrict__ ds_in,
                     T* __restrict__ dk, T* __restrict__ dv, int H, int S,
                     int D, float scale) {
  extern __shared__ float4 smem4[];
  const int D4 = (D + 3) & ~3, ldd = D4 + kPad, ldr = kBwdRows + kPad;
  float* sq = reinterpret_cast<float*>(smem4);  // kBwdRows x ldd
  float* sdo = sq + kBwdRows * ldd;             // kBwdRows x ldd
  float* spt = sdo + kBwdRows * ldd;            // kKeys x ldr (Pᵀ)
  float* sdst = spt + kKeys * ldr;              // kKeys x ldr (dSᵀ)
  const int k0 = blockIdx.x * kKeys, h = blockIdx.y, b = blockIdx.z;
  const long long bh = (long long)b * H + h;
  const long long head = bh * S * D;
  const long long sq_base = bh * S * S;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc_k[2][8] = {}, acc_v[2][8] = {};

  for (int r0 = 0; r0 < S; r0 += kBwdRows) {
    __syncthreads();
    load_rows(sq, ldd, q + head, r0, kBwdRows, S, D, D4);
    load_rows(sdo, ldd, dout + head, r0, kBwdRows, S, D, D4);
    for (int idx = threadIdx.x; idx < kBwdRows * kKeys; idx += kThreads) {
      const int r = idx / kKeys, c = idx - r * kKeys;
      const int gr = r0 + r, gc = k0 + c;
      const bool ok = gr < S && gc < S;
      const long long at = sq_base + (long long)gr * S + gc;
      spt[c * ldr + r] = ok ? to_f(p_in[at]) : 0.f;
      sdst[c * ldr + r] = ok ? to_f(ds_in[at]) : 0.f;
    }
    __syncthreads();
    const int rn = min(kBwdRows, S - r0);
    for (int r = 0; r < rn; r += 4) {
      float4 p4[2], s4[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        p4[i] = f4(spt + (ty * 2 + i) * ldr + r);
        s4[i] = f4(sdst + (ty * 2 + i) * ldr + r);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int d = tx * 4 + 64 * jj;
          if (d >= D4) continue;
          const float4 dov = f4(sdo + (r + kk) * ldd + d);
          const float4 qv = f4(sq + (r + kk) * ldd + d);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float pk = kk == 0 ? p4[i].x : kk == 1 ? p4[i].y
                           : kk == 2 ? p4[i].z : p4[i].w;
            const float sk = kk == 0 ? s4[i].x : kk == 1 ? s4[i].y
                           : kk == 2 ? s4[i].z : s4[i].w;
            axpy4(acc_v[i] + 4 * jj, pk, dov);
            axpy4(acc_k[i] + 4 * jj, sk, qv);
          }
        }
      }
    }
  }
  store_rows<T, 2>(dk + head, acc_k, k0, S, D, scale);
  store_rows<T, 2>(dv + head, acc_v, k0, S, D, 1.f);
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

template <typename T>
int launch_backward(const void* q, const void* k, const void* v,
                    const float* bias, const void* dout, void* dq, void* dk,
                    void* dv, void* p_buf, void* ds_buf, int B, int H, int S,
                    int D, float scale, cudaStream_t s) {
  const int Sp = padded(S), ldd = pad4(D) + kPad;
  const size_t rows_bytes = sizeof(float) *
      (size_t)((2 * kBwdRows + kChunk) * ldd + 2 * kBwdRows * (Sp + kPad));
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_rows_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)rows_bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 rows_grid((S + kBwdRows - 1) / kBwdRows, H, B);
  attn_bwd_rows_kernel<T><<<rows_grid, kThreads, rows_bytes, s>>>(
      (const T*)q, (const T*)k, (const T*)v, bias, (const T*)dout, (T*)dq,
      (T*)p_buf, (T*)ds_buf, H, S, D, Sp, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t keys_bytes = sizeof(float) *
      (size_t)(2 * kBwdRows * ldd + 2 * kKeys * (kBwdRows + kPad));
  err = cudaFuncSetAttribute(attn_bwd_keys_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)keys_bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 keys_grid((S + kKeys - 1) / kKeys, H, B);
  attn_bwd_keys_kernel<T><<<keys_grid, kThreads, keys_bytes, s>>>(
      (const T*)q, (const T*)dout, (const T*)p_buf, (const T*)ds_buf, (T*)dk,
      (T*)dv, H, S, D, scale);
  return (int)cudaGetLastError();
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

// As the forward, plus dout (B, H, S, D) and the outputs dq, dk, dv; p_buf
// and ds_buf are (B, H, S, S) scratch of the same dtype.
extern "C" int atq_attention_backward(int device, int dtype, const void* q,
                                      const void* k, const void* v,
                                      const float* bias, const void* dout,
                                      void* dq, void* dk, void* dv,
                                      void* p_buf, void* ds_buf, int B, int H,
                                      int S, int D, float scale,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (D > kMaxD) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 1
             ? launch_backward<__nv_bfloat16>(q, k, v, bias, dout, dq, dk, dv,
                                              p_buf, ds_buf, B, H, S, D,
                                              scale, s)
             : launch_backward<float>(q, k, v, bias, dout, dq, dk, dv, p_buf,
                                      ds_buf, B, H, S, D, scale, s);
}
