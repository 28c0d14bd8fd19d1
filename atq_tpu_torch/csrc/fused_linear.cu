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
// Forward and dx: gemm_kernel, a shared-memory f32 FMA GEMM. A 256-thread
// block owns a 64 x 64 output tile, walks the reduction axis in steps of
// 16, stages one 64 x 16 slice of each operand in shared memory, and each
// thread accumulates a 4 x 4 grid of outputs with FMAs in registers. Each
// weight element is ternarized and blended as it is loaded, so w_t and
// w_eff never exist in device memory (the TPU kernels do the same inside
// the VMEM tile). The forward has a short output (256 x 128 at the recipe)
// and a long reduction (K = 3136), which would give 8 blocks for 132 SMs;
// it splits K over grid.z into per-split partials that a second pass adds
// in a fixed order. Bound at the recipe's first layer (256 x 128 x 3136):
// 2·M·N·K = 205.5 MFLOP, 3.1 us at the 67 TFLOP/s f32 (non tensor core)
// rate, against about 5 MB, 1.5 us at 3.35 TB/s; this kernel has no
// tensor cores, no double buffering and no vector loads, and runs well
// below that bound.
//
// dW/dalpha: dwda_kernel, on the tensor cores. It forms G = gᵀx tile by
// tile and turns it into dw (mode dependent) and dalpha in the epilogue;
// G never reaches device memory. Both operands are f32 and neither is
// ternary, so the exact-bf16-weight trick of ternary_matmul.cu does not
// apply. The products are 3xTF32: each operand value v is split as
// hi = cvt.rna.tf32(v), lo = cvt.rna.tf32(v − hi) (hi + lo is v within
// 2^-22·|v|), and mma.sync m16n8k8 (tf32 in, f32 accumulate) sums
// lo·hi + hi·lo + hi·hi; lo·lo (about 2^-22 relative) is dropped. This was
// taken over bf16 terms on both sides (6 m16n8k16 MMAs a product) because
// it needs two splits where bf16 needs three, and half the MMAs and
// fragment registers; both run at the same third of the TF32 rate. So the
// f32 paths keep f32 accuracy (no plain TF32 or bf16 pass).
//
// Bound at 256 x 128 x 3136: 3 · 2·M·N·K = 616.6 MFLOP, 1.25 us at the
// 495 TFLOP/s TF32 rate, against 6.96 MB (g, x, w, mask read, dw written),
// 2.08 us at 3.35 TB/s: bytes bound it. The design against that:
// - g (M, N) and x (M, K) both have the reduction axis M as their slow
//   axis. wgmma reads tf32 operands from shared memory K-major only, so
//   this kernel uses mma.sync and loads its fragments by hand from tiles
//   kept as they lie in memory ([m][n] and [m][k] rows, padded to a stride
//   of 8 mod 32 words): no transpose pass, and every fragment load is free
//   of bank conflicts.
// - 64 (n) x 32 (k) output tiles give the recipe's (128, 3136) 196 blocks
//   for 132 SMs. A block has 8 warps in two groups of 4 (2 x 2 warps of
//   32 x 16 outputs each); group h takes rows 16h..16h+15 of every ring
//   stage into its own accumulators, and group 1 hands its sums to group 0
//   at the end (group 0 + group 1, a fixed order), so each warp's chain of
//   dependent MMAs is half a step long. Within a step the 12 MMAs run
//   product by product over the 4 tiles, so consecutive MMAs are
//   independent.
// - A 3-stage ring of 16-byte cp.async copies walks M in steps of 32
//   (zero-filled past M, N and K; 4-byte copies where a row is not 16-byte
//   aligned): the copies of step i + 2 are in flight during step i's MMAs,
//   one barrier a step.
// - The output rows and columns of each MMA are permuted (row slot r of
//   m16 tile i is row 4·(r % 8) + 2·i + r / 8 of the warp's 32, column slot
//   c of n8 tile j is column 2·c + j of its 16; the sum is unchanged), so
//   a thread reads its A fragments as two float4s and its B fragments as
//   two float2s a step, and owns a 4 x 4 block of G: the epilogue reads w
//   and the mask and stores dw as float4 / 32-bit rows. The w and mask
//   tiles are copied into shared memory with the first stage's copies, so
//   they land during the mainloop.
// - dalpha in the same launch, with the same bits every run: each block
//   reduces its partial in a fixed order (each thread's 16 values in
//   order, a warp butterfly, group 0's 4 warps in order) and writes it to its
//   slot; the last block to finish (an integer atomicAdd ticket after a
//   __threadfence) sums all slots in index order into dalpha and resets
//   the ticket to 0. No float atomics, no second kernel.
// Every variant writes every element of dw (parity without a mask writes
// zeros), so the caller allocates dw with torch.empty.
//
// Measured (PERF.md, H100 at 700 W): 0.0139 ms at 256 x 128 x 3136, 6.7x
// the bound and 1.32x cuBLAS's f32 gᵀx; 0.0126 ms at 256 x 10 x 128.
// Variants that drop one part each put it at about 5 us of MMAs and
// splits (617 MFLOP in ~6.8 us: mma.sync TF32 runs at ~90 TFLOP/s here),
// ~3.5 us of loads the ring does not hide and ~2 us of dalpha tail. One
// group of 4 warps and two of 4 were within 6 % of each other, and a
// 6-stage ring with the tail in warp group 1 was slower. wgmma (tf32
// operands K-major in shared memory, so a transposing stage) is the way
// to the TF32 rate.
//
// The mainloop (stage_tile + mma_tf32x3 over a cp.async ring) takes
// MN-major A and B tiles; dx and the forward can reuse it with their own
// tile loaders. The split, the MMA and the MN-major fragment reads live in
// tf32x3.cuh, shared with the attention backward.
//
// Ragged edges are masked in the loads and stores: x, w, g and the mask are
// read where they lie, with no padded copies. The bool mask is read as
// uint8. alpha and the threshold come from a 2-float device vector, so the
// launch needs no host sync.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"  // cp.async, the TF32 split, mma_tf32x3

namespace {

__device__ __forceinline__ float ternarize(float w, float thr) {
  return w > thr ? 1.f : (w < -thr ? -1.f : 0.f);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// ---------------------------------------------------------------------------
// gemm_kernel: forward and dx (f32 FMA).
// ---------------------------------------------------------------------------

constexpr int kBM = 64;       // output tile rows (operand A's output axis)
constexpr int kBN = 64;       // output tile cols (operand B's output axis)
constexpr int kBK = 16;       // reduction step
constexpr int kThreads = 256; // 16 x 16 threads, 4 x 4 outputs each
constexpr int kTM = kBM / 16;
constexpr int kTN = kBN / 16;

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
  const uint8_t* mask;  // precision mask or nullptr
  const float* scal;    // [alpha, threshold] on the device
  float* out;           // output (or split partials)
  int rows, cols;       // output shape
  int red;              // reduction length
  int lda, ldb;         // leading dimensions of A and B
  int chunk;            // reduction length per grid.z split
};

// One 64 x 64 output tile of C = A · B over the reduction range of this
// block's split. A_RC / B_RC: whether the operand's reduction axis is
// contiguous. B_BLEND: B is the weight, ternarized and blended on load.
template <bool A_RC, bool B_RC, bool B_BLEND, bool HAS_MASK>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(GemmArgs p) {
  __shared__ float as[kBK][kBM + 1];
  __shared__ float bs[kBK][kBN + 1];

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

template <bool A_RC, bool B_RC, bool B_BLEND, bool HAS_MASK>
cudaError_t launch_gemm(const GemmArgs& p, int splits, cudaStream_t stream) {
  dim3 grid((p.cols + kBN - 1) / kBN, (p.rows + kBM - 1) / kBM, splits);
  gemm_kernel<A_RC, B_RC, B_BLEND, HAS_MASK><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// dwda_kernel: dW/dalpha on the tensor cores (3xTF32 mma.sync).
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kTileA = 64;   // output rows a block (n)
constexpr int kTileB = 32;   // output cols a block (k)
constexpr int kStep = 32;    // reduction rows (m) a ring stage
constexpr int kStages = 3;
constexpr int kGroups = 2;   // warp groups: group h takes rows 16h..16h+15
                             // of every stage
constexpr int kGroupWarps = 4;  // 2 along the rows x 2 along the cols
constexpr int kWarps = kGroups * kGroupWarps;
constexpr int kThreads = 32 * kWarps;
constexpr int kLdA = kTileA + 8;  // padded strides: 8 mod 32 words
constexpr int kLdB = kTileB + 8;
constexpr int kStageFloats = kStep * (kLdA + kLdB);
constexpr int kLdW = kTileB + 4;   // the w tile's stride (floats)
constexpr int kLdMask = kTileB + 4;  // the mask tile's stride (bytes)
constexpr int kRingBytes = kStages * kStageFloats * 4;
constexpr int kWBytes = kTileA * kLdW * 4;
constexpr int kSmemBytes = kRingBytes + kWBytes + kTileA * kLdMask;

// Rows [r0, r0 + kRows) x columns [c0, c0 + kCols) of a row-major f32
// matrix (row stride ld floats, rows < R and columns < C valid) into s
// (row stride kLd floats), zeros elsewhere. vec: every row is 16-byte
// aligned, so 16-byte copies; else 4-byte copies.
template <int kRows, int kCols, int kLd>
__device__ __forceinline__ void stage_tile(float* s, const float* src,
                                           int ld, int r0, int R, int c0,
                                           int C, bool vec, int tid) {
  if (vec) {
    constexpr int kChunks = kCols / 4;
#pragma unroll
    for (int q = tid; q < kRows * kChunks; q += kThreads) {
      const int r = q / kChunks, col = c0 + 4 * (q % kChunks);
      const int bytes = r0 + r < R ? min(max(4 * (C - col), 0), 16) : 0;
      cp_async(s + r * kLd + (col - c0),
               bytes ? src + (size_t)(r0 + r) * ld + col : src, bytes);
    }
    return;
  }
  for (int e = tid; e < kRows * kCols; e += kThreads) {
    const int r = e / kCols, c = e % kCols;
    const bool ok = r0 + r < R && c0 + c < C;
    cp_async4(s + r * kLd + c,
              ok ? src + (size_t)(r0 + r) * ld + c0 + c : src, ok ? 4 : 0);
  }
}

// The block's kTileA x kTileB tile of the (N, K) uint8 mask into s (row
// stride kLdMask bytes), zeros past N and K: 4-byte copies where rows are
// 4-byte aligned (vec), else byte loads.
__device__ __forceinline__ void stage_mask(unsigned char* s,
                                           const uint8_t* mask, int n0,
                                           int N, int k0, int K, bool vec,
                                           int tid) {
  if (vec) {
    constexpr int kWords = kTileB / 4;
    for (int q = tid; q < kTileA * kWords; q += kThreads) {
      const int r = q / kWords, col = k0 + 4 * (q % kWords);
      const int bytes = n0 + r < N ? min(max(K - col, 0), 4) : 0;
      cp_async4(s + r * kLdMask + (col - k0),
                bytes ? mask + (size_t)(n0 + r) * K + col : mask, bytes);
    }
    return;
  }
  for (int e = tid; e < kTileA * kTileB; e += kThreads) {
    const int r = e / kTileB, c = e % kTileB;
    s[r * kLdMask + c] = n0 + r < N && k0 + c < K
                             ? mask[(size_t)(n0 + r) * K + k0 + c] : 0;
  }
}

struct DwdaArgs {
  const float* g;       // (M, N)
  const float* x;       // (M, K)
  const float* w;       // (N, K)
  const uint8_t* mask;  // (N, K) or nullptr
  const float* scal;    // [alpha, threshold]
  float* dw;            // (N, K)
  float* da;            // 1 float
  float* slots;         // one dalpha partial a block
  unsigned* ticket;     // 0 before the launch; left at 0
  int M, N, K;
  int vec;  // 16-byte aligned rows: bit 0 g, bit 1 x, bit 2 w and dw;
            // bit 3: 4-byte aligned mask rows
};

template <bool HAS_MASK, bool STE>
__global__ void __launch_bounds__(kThreads, 2)
dwda_kernel(DwdaArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  float* sw = reinterpret_cast<float*>(smem + kRingBytes);
  unsigned char* sm = smem + kRingBytes + kWBytes;
  __shared__ float warp_part[kGroupWarps];
  __shared__ bool last;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int grp = warp / kGroupWarps, wq = warp % kGroupWarps;
  const int wa = wq >> 1, wb = wq & 1;
  const int n0 = blockIdx.y * kTileA, k0 = blockIdx.x * kTileB;
  const int M = p.M, N = p.N, K = p.K;

  // The epilogue's w and mask tiles go with the first stage's copies, so
  // they land during the mainloop.
  stage_tile<kTileA, kTileB, kLdW>(sw, p.w, K, n0, N, k0, K, p.vec & 4, tid);
  if (HAS_MASK) stage_mask(sm, p.mask, n0, N, k0, K, p.vec & 8, tid);

  const int n_steps = (M + kStep - 1) / kStep;
  auto issue = [&](int i) {
    if (i < n_steps) {
      float* s = ring + (i % kStages) * kStageFloats;
      stage_tile<kStep, kTileA, kLdA>(s, p.g, N, i * kStep, M, n0, N,
                                      p.vec & 1, tid);
      stage_tile<kStep, kTileB, kLdB>(s + kStep * kLdA, p.x, K, i * kStep, M,
                                      k0, K, p.vec & 2, tid);
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };

  float acc[2][2][4] = {};
  constexpr int kRows = kStep / kGroups;  // a group's rows of a stage
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);
  for (int i = 0; i < n_steps; ++i) {
    cp_async_wait<kStages - 2>();  // step i has landed (this thread's part)
    __syncthreads();  // ... everyone's; and step i - 1's stage is free
    issue(i + kStages - 1);
    const float* s = ring + (i % kStages) * kStageFloats;
    mma_tf32x3<kRows / 8, kLdA, kLdB>(
        acc, s + grp * kRows * kLdA + 32 * wa,
        s + kStep * kLdA + grp * kRows * kLdB + 16 * wb, g, t);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free; w and the mask have landed

  // Group 1 hands its sums to group 0 through the ring, which adds them to
  // its own (group 0 + group 1, the same order every run).
  float* red = ring;
  const int gt = tid % (kThreads / kGroups);
  if (grp == 1) {
#pragma unroll
    for (int e = 0; e < 16; ++e)
      red[e * (kThreads / kGroups) + gt] = (&acc[0][0][0])[e];
  }
  __syncthreads();
  float part = 0.f;
  if (grp == 0) {
#pragma unroll
    for (int e = 0; e < 16; ++e)
      (&acc[0][0][0])[e] += red[e * (kThreads / kGroups) + gt];
    const float alpha = __ldg(p.scal), thr = __ldg(p.scal + 1);
    // This thread's 4 x 4 block of G: rows r + i, cols c + j of the tile.
    const int r = 32 * wa + 4 * g, c = 16 * wb + 4 * t;
    const int k = k0 + c;
    const bool row4 = (p.vec & 4) && k + 3 < K;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 w4 = *(const float4*)(sw + (r + i) * kLdW + c);
      const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
      const uint32_t mv =
          HAS_MASK ? *(const uint32_t*)(sm + (r + i) * kLdMask + c) : 0u;
      float d[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float G = acc[i >> 1][j & 1][2 * (i & 1) + (j >> 1)];
        const float wt = ternarize(wv[j], thr);
        if (HAS_MASK) {
          const float m = (mv >> (8 * j)) & 0xFFu ? 1.f : 0.f;
          const float inv_m = 1.f - m;
          part += G * wt * inv_m;
          d[j] = STE ? G * (alpha * inv_m + m) : G * m;
        } else {
          part += G * wt;
          d[j] = STE ? G * alpha : 0.f;
        }
      }
      // Past N or K, G and w are zeros: the partial gains exact zeros.
      const int n = n0 + r + i;
      if (n >= N) continue;
      float* out = p.dw + (size_t)n * K + k;
      if (row4) {
        *(float4*)out = make_float4(d[0], d[1], d[2], d[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (k + j < K) out[j] = d[j];
      }
    }
  }

  // dalpha: the block's partial in a fixed order (each thread's 16 values,
  // a warp butterfly, group 0's warps in order), then its slot; the last
  // block sums the slots in index order.
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(~0u, part, o);
  if (grp == 0 && lane == 0) warp_part[wq] = part;
  __syncthreads();
  const int slot = blockIdx.y * gridDim.x + blockIdx.x;
  const int n_slots = gridDim.x * gridDim.y;
  if (tid == 0) {
    float s = warp_part[0];
#pragma unroll
    for (int w = 1; w < kGroupWarps; ++w) s += warp_part[w];
    p.slots[slot] = s;
    __threadfence();
    last = atomicAdd(p.ticket, 1u) == (unsigned)(n_slots - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float s = 0.f;
  for (int i = tid; i < n_slots; i += kThreads) s += __ldcg(p.slots + i);
  red[tid] = s;
  __syncthreads();
#pragma unroll
  for (int h = kThreads / 2; h > 0; h >>= 1) {
    if (tid < h) red[tid] += red[tid + h];
    __syncthreads();
  }
  if (tid == 0) {
    p.da[0] = red[0];
    *p.ticket = 0u;  // ready for the next launch
  }
}

template <bool HAS_MASK, bool STE>
cudaError_t launch_dwda(const DwdaArgs& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      dwda_kernel<HAS_MASK, STE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return err;
  dim3 grid((p.K + kTileB - 1) / kTileB, (p.N + kTileA - 1) / kTileA);
  dwda_kernel<HAS_MASK, STE><<<grid, kThreads, kSmemBytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// Number of dalpha slots atq_fused_dwda writes for an (N, K) weight: one a
// block, the size of its `slots` scratch.
extern "C" int atq_fused_dwda_partials(int N, int K) {
  return ((K + tc::kTileB - 1) / tc::kTileB) *
         ((N + tc::kTileA - 1) / tc::kTileA);
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
  GemmArgs p{x, w, mask, scal, splits > 1 ? ws : y,
             M, N, K, K, K, splits > 1 ? chunk : K};
  err = mask ? launch_gemm<true, true, true, true>(p, splits, st)
             : launch_gemm<true, true, true, false>(p, splits, st);
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
  GemmArgs p{g, w, mask, scal, dx, M, K, N, N, K, N};
  err = mask ? launch_gemm<true, false, true, true>(p, 1, st)
             : launch_gemm<true, false, true, false>(p, 1, st);
  return (int)err;
}

// G (N, K) = g (M, N)ᵀ · x (M, K), then per element
//   dw = G·(alpha·(1−m) + m) (STE, mask), G·alpha (STE), G·m (parity, mask),
//   zeros (parity, no mask);
// and da[0] = sum G·tern(w)·(1−m), in one launch. slots:
// atq_fused_dwda_partials(N, K) floats of scratch; ticket: one unsigned
// that is 0 before the launch and is left at 0 by it.
extern "C" int atq_fused_dwda(int device, const float* g, const float* x,
                              const float* w, const uint8_t* mask,
                              const float* scal, float* dw, float* da,
                              float* slots, unsigned* ticket, int M, int N,
                              int K, int ste, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const int vec = (N % 4 == 0 && aligned16(g) ? 1 : 0) |
                  (K % 4 == 0 && aligned16(x) ? 2 : 0) |
                  (K % 4 == 0 && aligned16(w) && aligned16(dw) ? 4 : 0) |
                  (K % 4 == 0 && ((uintptr_t)mask & 3) == 0 ? 8 : 0);
  const tc::DwdaArgs p{g, x, w, mask, scal, dw, da, slots, ticket, M, N, K,
                       vec};
  if (mask) {
    err = ste ? tc::launch_dwda<true, true>(p, st)
              : tc::launch_dwda<true, false>(p, st);
  } else {
    err = ste ? tc::launch_dwda<false, true>(p, st)
              : tc::launch_dwda<false, false>(p, st);
  }
  return (int)err;
}
