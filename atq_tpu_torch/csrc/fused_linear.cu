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
// All three run on the tensor cores as 3xTF32, so the f32 paths keep f32
// accuracy (no plain TF32 or bf16 pass): each f32 operand value v is split
// as hi = cvt.rna.tf32(v), lo = cvt.rna.tf32(v − hi) (hi + lo is v within
// 2^-22·|v|), and mma.sync m16n8k8 (tf32 in, f32 accumulate) sums
// lo·hi + hi·lo + hi·hi; lo·lo (about 2^-22 relative) is dropped. 3xTF32
// was taken over bf16 terms on both sides (6 m16n8k16 MMAs a product)
// because it needs two splits where bf16 needs three, and half the MMAs and
// fragment registers; both run at the same third of the TF32 rate. mma.sync
// adds into its f32 accumulator by truncation, so each MMA step's three
// products go into a fresh partial that joins the running sum by a
// round-to-nearest add (step sums). The split, the MMA and the fragment
// readers live in tf32x3.cuh, shared with the attention backward. Both
// operands are f32 and the weight's ternary part is scaled by alpha, so the
// exact-bf16-weight trick of ternary_matmul.cu does not apply.
//
// Forward and dx: gemm_tc_kernel<DX, HAS_MASK>. A 256-thread block owns a
// 64 x 64 output tile; its 8 warps each own 16 rows x 32 columns (two
// 16 x 16 fragment tiles). A 3-stage ring of cp.async copies walks the
// reduction in steps of 32 (16-byte copies, 4-byte ones where a row is not
// 16-byte aligned; zeros past every edge): the copies of step i + 2 are in
// flight during step i's MMAs, one barrier a step. The raw weight rows and
// their mask bytes land in shared memory; each thread then blends the
// weight elements it copied into w_eff in place, before the barrier that
// releases the stage to the MMAs, so w_t and w_eff never exist in device
// memory (the TPU kernels do the same inside the VMEM tile); where rows are
// not aligned, the weight is read, blended and stored by plain loads.
// - dx (M, K) = g (M, N) · w_eff (N, K) reduces over N: g's tile has the
//   reduction contiguous and the weight's has it as the slow axis, read by
//   mma_nn16 (row strides 40 and 68 floats, 8 and 4 mod 32 words, so no
//   fragment load has a bank conflict). A lane owns 4 consecutive columns
//   of two rows of each fragment tile, and stores dx as float4 rows.
// - y (M, N) = x (M, K) · w_eff (N, K)ᵀ reduces over K: both tiles have
//   the reduction contiguous, read by mma_nt16 (row stride 40). The
//   recipe's output is short (256 x 128: 8 tiles) and its reduction long
//   (K = 3136), so the wrapper splits K over grid.z (forward_splits). Each
//   split writes its 64 x 64 partial to a workspace; the last block of the
//   tile to finish (an integer atomicAdd ticket after a __threadfence, one
//   ticket a tile) adds the partials in split order into y and resets the
//   ticket to 0. One launch, no float atomics, the same bits every run.
// Bound at the recipe's first layer (256 x 128 x 3136, with the mask):
// 3 · 2·M·N·K = 616.6 MFLOP, 1.25 us at the 495 TFLOP/s TF32 rate, against
// 5.35 MB (x or dx 3.21 MB, w 1.61 MB, the mask 0.40 MB, y or g 0.13 MB),
// 1.60 us at 3.35 TB/s: bytes bound both. mma.sync reaches about 90 of the
// 495 TFLOP/s here (dwda_kernel), so the MMAs take some 7 us of issue over
// the card; the forward's 8 output tiles fill it only through the split
// (33 splits of 96: 264 blocks, two an SM, were the fastest of 88 to 264).
// Measured (PERF.md, H100 at 700 W): dx 0.0120 ms, 1.26x cuBLAS's f32
// g·w_eff; the forward 0.0154 ms, 1.05x cuBLAS's x·w_effᵀ; 2- to 4-stage
// rings and steps of 64 were within 5 % of this one on the forward.
//
// dW/dalpha: dwda_kernel, on the tensor cores. It forms G = gᵀx tile by
// tile and turns it into dw (mode dependent) and dalpha in the epilogue;
// G never reaches device memory.
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
//   dependent MMAs is half a step long. Each MMA step's three products of
//   a tile go into a fresh partial that joins the tile's sum rounded to
//   nearest (step sums): summed straight into the accumulators, G drifted
//   toward zero, 23x the largest error at M = 2304 (PERF.md).
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
// Measured (PERF.md, H100 at 700 W): 0.0148 ms at 256 x 128 x 3136 with
// step sums (0.0139 without), 7.1x the bound and 1.44x cuBLAS's f32 gᵀx.
// Variants that drop one part each put it at about 5 us of MMAs and
// splits (617 MFLOP in ~6.8 us: mma.sync TF32 runs at ~90 TFLOP/s here),
// ~3.5 us of loads the ring does not hide and ~2 us of dalpha tail. One
// group of 4 warps and two of 4 were within 6 % of each other, and a
// 6-stage ring with the tail in warp group 1 was slower. wgmma (tf32
// operands K-major in shared memory, so a transposing stage) is the way
// to the TF32 rate.
//
// Ragged edges are masked in the loads and stores: x, w, g and the mask are
// read where they lie, with no padded copies. The bool mask is read as
// uint8. alpha and the threshold come from a 2-float device vector, so the
// launch needs no host sync.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"  // cp.async, the TF32 split, the fragment readers

namespace {

__device__ __forceinline__ float ternarize(float w, float thr) {
  return w > thr ? 1.f : (w < -thr ? -1.f : 0.f);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// 16-byte copies of the (N, K) weight's rows and 4-byte copies of its mask's.
bool weight_rows_aligned(const float* w, const uint8_t* mask, int K) {
  return K % 4 == 0 && aligned16(w) && ((uintptr_t)mask & 3) == 0;
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

// ---------------------------------------------------------------------------
// gemm_tc_kernel: the forward and dx on the tensor cores (3xTF32 mma.sync).
// ---------------------------------------------------------------------------

constexpr int kGTile = 64;    // output tile rows and columns
constexpr int kGStep = 32;    // reduction a ring stage
constexpr int kGStages = 3;
constexpr int kLdRed = kGStep + 8;  // rows with the reduction contiguous
constexpr int kLdOut = kGTile + 4;  // dx's weight rows (output contiguous)
// A stage: the A tile (64 x kLdRed), the weight tile (the forward's
// 64 x kLdRed or dx's 32 x kLdOut, which is smaller), then the weight
// tile's mask bytes (64 x 32 or 32 x 64, row stride its columns).
constexpr int kGStageFloats = 2 * kGTile * kLdRed;
constexpr int kGStageBytes = kGStageFloats * 4 + kGTile * kGStep;
constexpr int kGSmemBytes = kGStages * kGStageBytes;
static_assert(kGStep * kLdOut <= kGTile * kLdRed, "dx's weight tile fits");

__device__ __forceinline__ float blend(float v, bool m, float alpha,
                                       float thr) {
  return m ? v : ternarize(v, thr) * alpha;
}

// Rows [r0, r0 + kRows) x columns [c0, c0 + kCols) of the (N, K) weight
// into s (row stride kLd floats) and, with HAS_MASK, the same elements of
// the mask into sm (row stride kCols bytes), zeros past R rows and C
// columns. vec (16-byte aligned weight rows, 4-byte aligned mask rows):
// 16-byte copies of w and 4-byte copies of the mask, which blend_weight
// turns into w_eff once they land; else plain loads, blended here.
template <int kRows, int kCols, int kLd, bool HAS_MASK>
__device__ __forceinline__ void stage_weight(float* s, unsigned char* sm,
                                             const float* w,
                                             const uint8_t* mask, int K,
                                             int r0, int R, int c0, int C,
                                             bool vec, float alpha,
                                             float thr, int tid) {
  if (vec) {
    constexpr int kChunks = kCols / 4;
#pragma unroll
    for (int q = tid; q < kRows * kChunks; q += kThreads) {
      const int r = q / kChunks, c = 4 * (q % kChunks);
      const int left = r0 + r < R ? min(max(C - (c0 + c), 0), 4) : 0;
      const size_t off = left ? (size_t)(r0 + r) * K + c0 + c : 0;
      cp_async(s + r * kLd + c, w + off, 4 * left);
      if (HAS_MASK) cp_async4(sm + r * kCols + c, mask + off, left);
    }
    return;
  }
  for (int e = tid; e < kRows * kCols; e += kThreads) {
    const int r = e / kCols, c = e % kCols;
    float v = 0.f;
    if (r0 + r < R && c0 + c < C) {
      const size_t off = (size_t)(r0 + r) * K + c0 + c;
      v = blend(__ldg(w + off), HAS_MASK && __ldg(mask + off), alpha, thr);
    }
    s[r * kLd + c] = v;
  }
}

// The elements stage_weight's 16-byte copies put in place for this thread,
// turned into w_eff where they lie. Called once the copies have landed
// (cp_async_wait) and before the barrier that hands the stage to the MMAs.
template <int kRows, int kCols, int kLd, bool HAS_MASK>
__device__ __forceinline__ void blend_weight(float* s, const unsigned char* sm,
                                             float alpha, float thr,
                                             int tid) {
  constexpr int kChunks = kCols / 4;
#pragma unroll
  for (int q = tid; q < kRows * kChunks; q += kThreads) {
    const int r = q / kChunks, c = 4 * (q % kChunks);
    float4* p = reinterpret_cast<float4*>(s + r * kLd + c);
    const uint32_t m =
        HAS_MASK ? *reinterpret_cast<const uint32_t*>(sm + r * kCols + c)
                 : 0u;
    float4 v = *p;
    v.x = blend(v.x, m & 0xFFu, alpha, thr);
    v.y = blend(v.y, (m >> 8) & 0xFFu, alpha, thr);
    v.z = blend(v.z, (m >> 16) & 0xFFu, alpha, thr);
    v.w = blend(v.w, m >> 24, alpha, thr);
    *p = v;
  }
}

struct GemmArgs {
  const float* a;       // x (M, K) for the forward, g (M, N) for dx
  const float* w;       // (N, K)
  const uint8_t* mask;  // (N, K) or nullptr
  const float* scal;    // [alpha, threshold]
  float* out;           // y (M, N) or dx (M, K)
  float* parts;         // forward, gridDim.z > 1: a 64 x 64 partial a block
  unsigned* tickets;    // forward, gridDim.z > 1: one an output tile, 0
                        // before the launch; left at 0
  int M, N, K;
  int chunk;            // forward: the reduction a split covers
  int vec;  // bit 0: A rows 16-byte aligned; bit 1: w rows 16-byte and
            // mask rows 4-byte aligned; bit 2: dx rows 16-byte aligned
};

// kSteps MMA steps, from step ks0 of a ring stage, into a warp's two
// 16 x 16 tiles (columns 32·wc + 16h of the block's 64): sa = the warp's
// 16 A rows of the stage, sb = the stage's weight tile.
template <bool DX, int kSteps>
__device__ __forceinline__ void gemm_mma(float (&acc)[2][2][4],
                                         const float* sa, const float* sb,
                                         int ks0, int wc, int g, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if constexpr (DX)
      mma_nn16<kSteps, kLdOut, true>(
          acc[h], sa + 8 * ks0, kLdRed,
          sb + 8 * ks0 * kLdOut + 32 * wc + 16 * h, g, t);
    else
      mma_nt16<kSteps, kLdRed, true>(
          acc[h], sa + 8 * ks0, sb + (32 * wc + 16 * h) * kLdRed + 8 * ks0,
          g, t);
  }
}

// One 64 x 64 tile of dx (DX) or of y over this block's split of K.
template <bool DX, bool HAS_MASK>
__global__ void __launch_bounds__(kThreads, 2)
gemm_tc_kernel(GemmArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ bool last;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp & 3, wc = warp >> 2;  // rows 16·wr, columns 32·wc
  const int r0 = blockIdx.y * kGTile, c0 = blockIdx.x * kGTile;
  const int M = p.M, N = p.N, K = p.K;
  const float alpha = __ldg(p.scal), thr = __ldg(p.scal + 1);
  // dx reduces over all of N; the forward over its split of K.
  const int red0 = DX ? 0 : blockIdx.z * p.chunk;
  const int red1 = DX ? N : min(K, red0 + p.chunk);
  const int n_steps = (red1 - red0 + kGStep - 1) / kGStep;
  const bool wvec = p.vec & 2;

  auto stage = [&](int i) {
    return reinterpret_cast<float*>(smem + (i % kGStages) * kGStageBytes);
  };
  auto stage_mask_bytes = [&](float* s) {
    return reinterpret_cast<unsigned char*>(s + kGStageFloats);
  };
  auto issue = [&](int i) {
    if (i < n_steps) {
      float* s = stage(i);
      const int k0 = red0 + i * kGStep;
      stage_tile<kGTile, kGStep, kLdRed>(s, p.a, DX ? N : K, r0, M, k0, red1,
                                         p.vec & 1, tid);
      float* sb = s + kGTile * kLdRed;
      if constexpr (DX)
        stage_weight<kGStep, kGTile, kLdOut, HAS_MASK>(
            sb, stage_mask_bytes(s), p.w, p.mask, K, k0, N, c0, K, wvec,
            alpha, thr, tid);
      else
        stage_weight<kGTile, kGStep, kLdRed, HAS_MASK>(
            sb, stage_mask_bytes(s), p.w, p.mask, K, c0, N, k0, red1, wvec,
            alpha, thr, tid);
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };

  float acc[2][2][4] = {};  // [16-column tile][n8 tile][fragment]
#pragma unroll
  for (int i = 0; i < kGStages - 1; ++i) issue(i);
  for (int i = 0; i < n_steps; ++i) {
    cp_async_wait<kGStages - 2>();  // step i has landed (this thread's part)
    float* s = stage(i);
    float* sb = s + kGTile * kLdRed;
    if (wvec) {
      if constexpr (DX)
        blend_weight<kGStep, kGTile, kLdOut, HAS_MASK>(
            sb, stage_mask_bytes(s), alpha, thr, tid);
      else
        blend_weight<kGTile, kGStep, kLdRed, HAS_MASK>(
            sb, stage_mask_bytes(s), alpha, thr, tid);
    }
    __syncthreads();  // ... everyone's, blended; step i - 1's stage is free
    issue(i + kGStages - 1);
    const float* sa = s + 16 * wr * kLdRed;
    // A stage short of kGStep rows (dx at N = 10, a ragged end of K) runs
    // only the MMA steps that reach its rows, not steps of zeros.
    const int left = red1 - red0 - i * kGStep;
    if (left >= kGStep) {
      gemm_mma<DX, kGStep / 8>(acc, sa, sb, 0, wc, g, t);
    } else {
#pragma unroll
      for (int ks = 0; ks < kGStep / 8; ++ks)
        if (8 * ks < left) gemm_mma<DX, 1>(acc, sa, sb, ks, wc, g, t);
    }
  }
  cp_async_wait<0>();

  if constexpr (DX) {
    // Lane (g, t) owns rows g, g + 8 and columns 4t..4t+3 of each 16 x 16
    // tile: element (g + 8e, 4t + c) is acc[h][c & 1][2e + (c >> 1)].
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = r0 + 16 * wr + g + 8 * e;
        const int k = c0 + 32 * wc + 16 * h + 4 * t;
        if (m >= M) continue;
        const float v[4] = {acc[h][0][2 * e], acc[h][1][2 * e],
                            acc[h][0][2 * e + 1], acc[h][1][2 * e + 1]};
        float* out = p.out + (size_t)m * K + k;
        if ((p.vec & 4) && k + 3 < K) {
          *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2],
                                                        v[3]);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (k + c < K) out[c] = v[c];
        }
      }
    }
    return;
  }

  // The forward. Lane (g, t) owns rows g, g + 8 and columns 2t, 2t + 1 of
  // n8 tile j of each 16 x 16 tile: acc[h][j][2e + c] is row g + 8e,
  // column 16h + 8j + 2t + c of the warp's 16 x 32.
  const int splits = gridDim.z;
  if (splits == 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = r0 + 16 * wr + g + 8 * e;
          const int n = c0 + 32 * wc + 16 * h + 8 * j + 2 * t;
          if (m >= M) continue;
          if (n < N) p.out[(size_t)m * N + n] = acc[h][j][2 * e];
          if (n + 1 < N) p.out[(size_t)m * N + n + 1] = acc[h][j][2 * e + 1];
        }
    return;
  }
  // Split K: this block's partial into its slot of the tile's run of
  // partials; the tile's last block to finish adds them in split order.
  constexpr int kTileFloats = kGTile * kGTile;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  float* tile_parts = p.parts + (size_t)tile * splits * kTileFloats;
  float* part = tile_parts + (size_t)blockIdx.z * kTileFloats;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        *reinterpret_cast<float2*>(
            part + (16 * wr + g + 8 * e) * kGTile + 32 * wc + 16 * h +
            8 * j + 2 * t) = make_float2(acc[h][j][2 * e],
                                         acc[h][j][2 * e + 1]);
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last = atomicAdd(p.tickets + tile, 1u) == (unsigned)(splits - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  // Thread tid sums float4 q = tid + kThreads·i of the tile, i < 4, over
  // the splits in order: four independent loads in flight a split.
  constexpr int kQ = kTileFloats / 4 / kThreads;
  const float4* src = reinterpret_cast<const float4*>(tile_parts);
  float4 sum[kQ];
#pragma unroll
  for (int i = 0; i < kQ; ++i) sum[i] = __ldcg(src + tid + kThreads * i);
  for (int z = 1; z < splits; ++z) {
    const float4* pz = src + (size_t)z * (kTileFloats / 4);
#pragma unroll
    for (int i = 0; i < kQ; ++i) {
      const float4 v = __ldcg(pz + tid + kThreads * i);
      sum[i].x += v.x;
      sum[i].y += v.y;
      sum[i].z += v.z;
      sum[i].w += v.w;
    }
  }
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
    const int q = 4 * (tid + kThreads * i);
    const int m = r0 + q / kGTile, n = c0 + q % kGTile;
    if (m >= M) continue;
    const float v[4] = {sum[i].x, sum[i].y, sum[i].z, sum[i].w};
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (n + c < N) p.out[(size_t)m * N + n + c] = v[c];
  }
  if (tid == 0) p.tickets[tile] = 0u;  // ready for the next launch
}

template <bool DX, bool HAS_MASK>
cudaError_t launch_gemm_tc(const GemmArgs& p, dim3 grid, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      gemm_tc_kernel<DX, HAS_MASK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kGSmemBytes);
  if (err != cudaSuccess) return err;
  gemm_tc_kernel<DX, HAS_MASK><<<grid, kThreads, kGSmemBytes, st>>>(p);
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

// y (M, N) = x (M, K) · w_eff (N, K)ᵀ in one launch. splits > 1 divides K
// into runs of `chunk` over grid.z: then `parts` holds
// ceil(M/64)·ceil(N/64) tiles · splits · 4096 floats of partials and
// `tickets` one unsigned a tile, 0 before the launch and left at 0 by it.
// mask: (N, K) uint8/bool or null. scal: [alpha, threshold]. Returns the
// cudaError_t of the launch.
extern "C" int atq_fused_forward(int device, const float* x, const float* w,
                                 const uint8_t* mask, const float* scal,
                                 float* y, float* parts, unsigned* tickets,
                                 int M, int N, int K, int splits, int chunk,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int vec = (K % 4 == 0 && aligned16(x) ? 1 : 0) |
                  (weight_rows_aligned(w, mask, K) ? 2 : 0);
  const tc::GemmArgs p{x, w, mask, scal, y, parts, tickets, M, N, K,
                       splits > 1 ? chunk : K, vec};
  const dim3 grid((N + tc::kGTile - 1) / tc::kGTile,
                  (M + tc::kGTile - 1) / tc::kGTile, max(splits, 1));
  cudaStream_t st = (cudaStream_t)stream;
  err = mask ? tc::launch_gemm_tc<false, true>(p, grid, st)
             : tc::launch_gemm_tc<false, false>(p, grid, st);
  return (int)err;
}

// dx (M, K) = g (M, N) · w_eff (N, K).
extern "C" int atq_fused_dx(int device, const float* g, const float* w,
                            const uint8_t* mask, const float* scal, float* dx,
                            int M, int N, int K, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int vec = (N % 4 == 0 && aligned16(g) ? 1 : 0) |
                  (weight_rows_aligned(w, mask, K) ? 2 : 0) |
                  (K % 4 == 0 && aligned16(dx) ? 4 : 0);
  const tc::GemmArgs p{g, w, mask, scal, dx, nullptr, nullptr, M, N, K, 0,
                       vec};
  const dim3 grid((K + tc::kGTile - 1) / tc::kGTile,
                  (M + tc::kGTile - 1) / tc::kGTile);
  cudaStream_t st = (cudaStream_t)stream;
  err = mask ? tc::launch_gemm_tc<true, true>(p, grid, st)
             : tc::launch_gemm_tc<true, false>(p, grid, st);
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
