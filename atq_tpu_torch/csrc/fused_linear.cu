// Fused ternarize + blend + matmul for the training path: the forward, the
// input gradient and the weight/alpha gradients of
//   y = x · w_effᵀ,   w_eff = tern(w, thr)·alpha·(1 − m) + w·m
// where tern(w, thr) is +1 for w > thr, −1 for w < −thr and 0 otherwise
// (strict compares, as the dense quantizer), and m is the optional bool
// precision mask (no mask: w_eff = tern(w, thr)·alpha).
//
// Replaces the Pallas TPU kernels of atq_tpu/ops/fused_linear.py:
//   atq_fused_forward  <- _fwd_kernel / _fwd_kernel_nomask   (_pallas_forward)
//   atq_fused_dx       <- _dx_kernel / _dx_kernel_nomask     (_pallas_dx)
//   atq_fused_dwda     <- _dwda_kernel / _dwda_kernel_nomask (_pallas_dwda)
// Each is one kernel template with a has_mask switch (and, for dW, the
// STE/parity switch), so the mask and no-mask variants share one body.
//
// Design. All three are the same shared-memory f32 GEMM: a 256-thread block
// owns a 64 x 64 output tile, walks the reduction axis in steps of 16, stages
// one 64 x 16 slice of each operand in shared memory, and each thread
// accumulates a 4 x 4 grid of outputs with FMAs in registers. What differs
// is how each operand is read (reduction axis contiguous or not) and what
// happens to the weight on its way into shared memory or out of the
// accumulators:
// - forward and dx ternarize and blend each weight element as it is loaded,
//   so w_t and w_eff never exist in device memory (the TPU kernels do the
//   same inside the VMEM tile);
// - dW/dalpha forms G = gᵀx tile by tile and turns it into dw (mode
//   dependent) and a dalpha partial in the epilogue; G never reaches device
//   memory. The TPU kernel keeps the whole batch resident and carries dalpha
//   in one SMEM scalar across an in-order grid; here the block loops over M
//   (any batch size, no fallback) and writes one dalpha partial per block,
//   which a second one-block pass sums in a fixed order, so dalpha is the
//   same from run to run (no float atomics).
// - The forward has a short output (256 x 128 at the recipe) and a long
//   reduction (K = 3136), which would give 8 blocks for 132 SMs; it splits K
//   over grid.z into per-split partials that a second pass adds in a fixed
//   order.
// Ragged edges are masked in the loads and stores: x, w, g and the mask are
// read where they lie, with no padded copies. The bool mask is read as
// uint8. alpha and the threshold come from a 2-float device vector, so the
// launch needs no host sync.
//
// Bound: at the recipe's first layer (256 x 128 x 3136) each kernel does
// 2·M·N·K = 205.5 MFLOP, 3.1 us at the 67 TFLOP/s f32 (non tensor core)
// rate, and moves about 5 MB, 1.5 us at 3.35 TB/s: operations bound it.
// This kernel uses no tensor cores (f32 FMA only, to match the f32
// reference bit for bit in the pattern and closely in the sums), no
// double buffering and no vector loads, so it runs well below that bound;
// wgmma (TF32 or split-f32) and TMA staging are the next steps.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;       // output tile rows (operand A's output axis)
constexpr int kBN = 64;       // output tile cols (operand B's output axis)
constexpr int kBK = 16;       // reduction step
constexpr int kThreads = 256; // 16 x 16 threads, 4 x 4 outputs each
constexpr int kTM = kBM / 16;
constexpr int kTN = kBN / 16;
constexpr int kReduceThreads = 256;

enum Epilogue { kStore = 0, kDwDa = 1 };

__device__ __forceinline__ float ternarize(float w, float thr) {
  return w > thr ? 1.f : (w < -thr ? -1.f : 0.f);
}

// Stage a kBX (output) x kBK (reduction) slice of an operand into
// s[red][out]. RC: the reduction index is the contiguous one
// (address = out * ld + red); otherwise address = red * ld + out. BLEND
// turns the weight into w_eff as it is loaded (with the mask if HAS_MASK).
template <int kBX, bool RC, bool BLEND, bool HAS_MASK>
__device__ __forceinline__ void load_tile(float (*s)[kBX + 1],
                                          const float* __restrict__ src,
                                          const uint8_t* __restrict__ mask,
                                          int ld, int out_total, int red_end,
                                          int out0, int red0, float alpha,
                                          float thr) {
#pragma unroll
  for (int r = 0; r < (kBX * kBK) / kThreads; ++r) {
    const int idx = threadIdx.x + r * kThreads;
    const int o = RC ? idx / kBK : idx % kBX;
    const int k = RC ? idx % kBK : idx / kBX;
    const int go = out0 + o, gk = red0 + k;
    float v = 0.f;
    if (go < out_total && gk < red_end) {
      const size_t off = RC ? (size_t)go * ld + gk : (size_t)gk * ld + go;
      v = __ldg(src + off);
      if (BLEND) {
        float eff = ternarize(v, thr) * alpha;
        if (HAS_MASK && __ldg(mask + off)) eff = v;
        v = eff;
      }
    }
    s[k][o] = v;
  }
}

struct GemmArgs {
  const float* a;       // operand A (output rows)
  const float* b;       // operand B (output cols)
  const float* w;       // weight, for the dW/dalpha epilogue
  const uint8_t* mask;  // precision mask or nullptr
  const float* scal;    // [alpha, threshold] on the device
  float* out;           // forward/dx output (or split partials); dw
  float* partials;      // dW/dalpha: one dalpha partial per block
  int rows, cols;       // output shape
  int red;              // reduction length
  int lda, ldb;         // leading dimensions of A and B
  int chunk;            // reduction length per grid.z split
};

// One 64 x 64 output tile of C = A · B over the reduction range of this
// block's split. A_RC / B_RC: whether the operand's reduction axis is
// contiguous. B_BLEND: B is the weight, ternarized and blended on load.
template <bool A_RC, bool B_RC, bool B_BLEND, bool HAS_MASK, int EPI, bool STE>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(GemmArgs p) {
  __shared__ float as[kBK][kBM + 1];
  __shared__ float bs[kBK][kBN + 1];
  __shared__ float red_buf[EPI == kDwDa ? kThreads : 1];

  const float alpha = __ldg(p.scal), thr = __ldg(p.scal + 1);
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;
  const int red_begin = blockIdx.z * p.chunk;
  const int red_end = min(p.red, red_begin + p.chunk);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int k0 = red_begin; k0 < red_end; k0 += kBK) {
    load_tile<kBM, A_RC, false, false>(as, p.a, nullptr, p.lda, p.rows,
                                       red_end, row0, k0, alpha, thr);
    load_tile<kBN, B_RC, B_BLEND, HAS_MASK>(bs, p.b, p.mask, p.ldb, p.cols,
                                            red_end, col0, k0, alpha, thr);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[kTM], bv[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) av[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) bv[j] = bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  if (EPI == kStore) {
    float* out = p.out + (size_t)blockIdx.z * p.rows * p.cols;
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int r = row0 + ty + 16 * i;
      if (r >= p.rows) continue;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int c = col0 + tx + 16 * j;
        if (c < p.cols) out[(size_t)r * p.cols + c] = acc[i][j];
      }
    }
    return;
  }

  // dW/dalpha epilogue: rows are n, cols are k; G = acc.
  float part = 0.f;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int n = row0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int k = col0 + tx + 16 * j;
      if (n >= p.rows || k >= p.cols) continue;
      const size_t off = (size_t)n * p.cols + k;
      const float g = acc[i][j];
      const float wt = ternarize(__ldg(p.w + off), thr);
      if (HAS_MASK) {
        const float m = __ldg(p.mask + off) ? 1.f : 0.f;
        const float inv_m = 1.f - m;
        part += g * wt * inv_m;
        p.out[off] = STE ? g * (alpha * inv_m + m) : g * m;
      } else {
        part += g * wt;
        if (STE) p.out[off] = g * alpha;  // parity: dw stays the zeros
      }
    }
  }
  // Fixed-order block reduction of the dalpha partial.
  red_buf[threadIdx.x] = part;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red_buf[threadIdx.x] += red_buf[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    p.partials[blockIdx.y * gridDim.x + blockIdx.x] = red_buf[0];
  }
}

// out[i] = sum_z parts[z * n + i], z in order.
__global__ void sum_splits_kernel(const float* __restrict__ parts,
                                  float* __restrict__ out, int n,
                                  int splits) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += __ldg(parts + (size_t)z * n + i);
    out[i] = s;
  }
}

// out[0] = sum of n partials, in a fixed order (one block).
__global__ void __launch_bounds__(kReduceThreads)
sum_partials_kernel(const float* __restrict__ parts, float* __restrict__ out,
                    int n) {
  __shared__ float buf[kReduceThreads];
  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += kReduceThreads) s += __ldg(parts + i);
  buf[threadIdx.x] = s;
  __syncthreads();
  for (int h = kReduceThreads / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) buf[threadIdx.x] += buf[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = buf[0];
}

template <bool A_RC, bool B_RC, bool B_BLEND, bool HAS_MASK, int EPI, bool STE>
cudaError_t launch_gemm(const GemmArgs& p, int splits, cudaStream_t stream) {
  dim3 grid((p.cols + kBN - 1) / kBN, (p.rows + kBM - 1) / kBM, splits);
  gemm_kernel<A_RC, B_RC, B_BLEND, HAS_MASK, EPI, STE>
      <<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Number of dalpha partials atq_fused_dwda writes for an (N, K) weight: the
// size of its `partials` scratch.
extern "C" int atq_fused_dwda_partials(int N, int K) {
  return ((K + kBN - 1) / kBN) * ((N + kBM - 1) / kBM);
}

// y (M, N) = x (M, K) · w_eff (N, K)ᵀ. With splits > 1, `ws` holds
// splits·M·N floats of partials, each split covering `chunk` (a multiple of
// 16) of K, and a second pass adds them in order. mask: (N, K) uint8/bool or
// null. scal: [alpha, threshold]. Returns the cudaError_t of the launches.
extern "C" int atq_fused_forward(int device, const float* x, const float* w,
                                 const uint8_t* mask, const float* scal,
                                 float* y, float* ws, int M, int N, int K,
                                 int splits, int chunk, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  GemmArgs p{x, w, nullptr, mask, scal, splits > 1 ? ws : y, nullptr,
             M, N, K, K, K, splits > 1 ? chunk : K};
  err = mask ? launch_gemm<true, true, true, true, kStore, false>(p, splits, st)
             : launch_gemm<true, true, true, false, kStore, false>(p, splits,
                                                                  st);
  if (err != cudaSuccess || splits <= 1) return (int)err;
  const int n = M * N;
  const int blocks = min((n + 255) / 256, 4 * 132);
  sum_splits_kernel<<<blocks, 256, 0, st>>>(ws, y, n, splits);
  return (int)cudaGetLastError();
}

// dx (M, K) = g (M, N) · w_eff (N, K).
extern "C" int atq_fused_dx(int device, const float* g, const float* w,
                            const uint8_t* mask, const float* scal, float* dx,
                            int M, int N, int K, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  GemmArgs p{g, w, nullptr, mask, scal, dx, nullptr, M, K, N, N, K, N};
  err = mask ? launch_gemm<true, false, true, true, kStore, false>(p, 1, st)
             : launch_gemm<true, false, true, false, kStore, false>(p, 1, st);
  return (int)err;
}

// G (N, K) = g (M, N)ᵀ · x (M, K), then per element
//   dw = G·(alpha·(1−m) + m) (STE, mask), G·alpha (STE), G·m (parity, mask);
//   parity without a mask leaves dw untouched (the caller passes zeros);
// and dalpha = sum G·tern(w)·(1−m), reduced over `partials`
// (atq_fused_dwda_partials(N, K) floats) into da[0] in a fixed order.
extern "C" int atq_fused_dwda(int device, const float* g, const float* x,
                              const float* w, const uint8_t* mask,
                              const float* scal, float* dw, float* da,
                              float* partials, int M, int N, int K, int ste,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  GemmArgs p{g, x, w, mask, scal, dw, partials, N, K, M, N, K, M};
  if (mask) {
    err = ste ? launch_gemm<false, false, false, true, kDwDa, true>(p, 1, st)
              : launch_gemm<false, false, false, true, kDwDa, false>(p, 1, st);
  } else {
    err = ste ? launch_gemm<false, false, false, false, kDwDa, true>(p, 1, st)
              : launch_gemm<false, false, false, false, kDwDa, false>(p, 1,
                                                                     st);
  }
  if (err != cudaSuccess) return (int)err;
  sum_partials_kernel<<<1, kReduceThreads, 0, st>>>(
      partials, da, atq_fused_dwda_partials(N, K));
  return (int)cudaGetLastError();
}
