// Exact order statistic of a non-negative float32 vector, with its max and
// its sum: (sorted(x)[rank], max(x), sum(x)); or of each row of a stacked
// (L, n) tensor, with one rank per row.
//
// Replaces the Pallas TPU kernels atq_tpu/ops/order_stat.py:_kernel (reached
// through _pallas_select / order_statistic_reductions) and :_batched_kernel
// (through _pallas_select_batched / order_statistic_reductions_batched). The
// TPU kernels keep the whole
// bit matrix resident in VMEM and runs a 31-round bisection over it in one
// launch. A Hopper block holds at most 227 KB of shared memory, and 31
// rounds from one SM would be bound by that SM's share of L2, so the design
// is different: an MSB-first radix select over the uint32 bit patterns
// (non-negative IEEE-754 floats order as their bit patterns, so the result is
// bit-identical to the sort).
//
//   pass p = 0..3: every block of a multi-block grid builds a 256-bin integer
//     histogram of digit p (bits 31-8p .. 24-8p) over the elements whose
//     higher digits match the prefix fixed so far, in shared memory with
//     warp-aggregated atomics, and adds it into hist[p] in device memory.
//     Each block re-derives the prefix from hist[0..p-1] with one warp (a
//     scan of 256 bins per earlier pass), so no separate select launch sits
//     between passes. Pass 0 also takes each block's max and f32 sum.
//   finalize (one block): picks the last digit, writes the statistic, and
//     reduces the per-block max and sum in a fixed order, so the sum is the
//     same from run to run.
// Integer histograms make the selected bits exact whatever order the atomics
// run in. The rank is read from device memory: the caller never syncs.
//
// Stacked rows (the hoisted quantizer's (L, out*in) weights): blockIdx.y is
// the row. Each row has its own histograms, rank, partial sums and output
// slot, so one fixed sequence of five launches covers all L rows whatever L
// is; the TPU kernel's one-VMEM-scratch-and-DMA-per-layer design has no
// counterpart. Bound: one read of 4*L*n bytes (8.5 us at (12, 589,824) and
// 34 us at (12, 2,359,296) at 3.35 TB/s); the passes re-read mostly from L2.
//
// Bound: one read of the 4n input bytes at 3.35 TB/s (about 0.48 us at the
// serving size n = 401,408). The four passes read the input four times (the
// later three mostly from the 50 MB L2), and six launches on one stream make
// the kernel launch-bound at serving sizes; a later change may fold the passes
// into one persistent launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBins = 256;
constexpr int kPasses = 4;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ unsigned clamp_rank(const int* rank_ptr,
                                               long long n) {
  long long r = *rank_ptr;
  if (r < 0) r = 0;
  if (r > n - 1) r = n - 1;
  return (unsigned)r;
}

// Called by all 32 lanes of one warp. Finds the bin of the 256-bin histogram
// `h` that holds rank `r` (0-based) and the rank left inside that bin.
__device__ __forceinline__ void select_digit(const unsigned* h, unsigned r,
                                             unsigned* digit,
                                             unsigned* rest) {
  const int lane = threadIdx.x & 31;
  unsigned v[8];
  unsigned s = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    v[j] = h[lane * 8 + j];
    s += v[j];
  }
  unsigned incl = s;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    unsigned t = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += t;
  }
  const unsigned excl = incl - s;
  const unsigned ballot = __ballot_sync(kFull, incl > r);
  const int src = ballot ? __ffs(ballot) - 1 : 31;
  unsigned d = 255, rr = 0;
  if (lane == src) {
    unsigned cum = excl;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (r < cum + v[j]) {
        d = lane * 8 + j;
        rr = r - cum;
        break;
      }
      cum += v[j];
    }
  }
  *digit = __shfl_sync(kFull, d, src);
  *rest = __shfl_sync(kFull, rr, src);
}

// Prefix of the digits fixed by passes [0, pass), and the rank left inside
// it. All 32 lanes of one warp.
__device__ __forceinline__ void resolve_prefix(const unsigned* hist, int pass,
                                               unsigned r, unsigned* prefix,
                                               unsigned* rest) {
  unsigned p = 0;
  for (int q = 0; q < pass; ++q) {
    unsigned d, rr;
    select_digit(hist + q * kBins, r, &d, &rr);
    p |= d << (24 - 8 * q);
    r = rr;
  }
  *prefix = p;
  *rest = r;
}

// Fixed-order block reduction of (sum, max); result valid in thread 0.
__device__ __forceinline__ void block_sum_max(float* s, float* m) {
  __shared__ float red_s[kThreads / 32];
  __shared__ float red_m[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    *s += __shfl_xor_sync(kFull, *s, off);
    *m = fmaxf(*m, __shfl_xor_sync(kFull, *m, off));
  }
  if (lane == 0) {
    red_s[warp] = *s;
    red_m[warp] = *m;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float ts = 0.f, tm = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) {
      ts += red_s[w];
      tm = fmaxf(tm, red_m[w]);
    }
    *s = ts;
    *m = tm;
  }
}

__global__ void __launch_bounds__(kThreads)
radix_hist_kernel(const unsigned* __restrict__ bits, long long n,
                  const int* __restrict__ rank_ptr, unsigned* hist,
                  float* part_sum, float* part_max, int pass) {
  const int row = blockIdx.y;
  bits += (long long)row * n;
  rank_ptr += row;
  hist += row * kPasses * kBins;
  part_sum += (long long)row * gridDim.x;
  part_max += (long long)row * gridDim.x;
  __shared__ unsigned sh[kBins];
  __shared__ unsigned s_prefix;
  for (int i = threadIdx.x; i < kBins; i += blockDim.x) sh[i] = 0;
  if (threadIdx.x < 32) {
    unsigned prefix, rest;
    resolve_prefix(hist, pass, clamp_rank(rank_ptr, n), &prefix, &rest);
    if (threadIdx.x == 0) s_prefix = prefix;
  }
  __syncthreads();

  const int shift = 24 - 8 * pass;
  const unsigned hi_mask = pass == 0 ? 0u : (kFull << (shift + 8));
  const unsigned prefix = s_prefix;
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * blockDim.x;
  float lsum = 0.f, lmax = 0.f;
  // The loop bound is uniform across each warp (base is block-uniform), so
  // every lane reaches the full-mask __match_any_sync below.
  for (long long base = (long long)blockIdx.x * blockDim.x; base < n;
       base += stride) {
    const long long i = base + threadIdx.x;
    const bool valid = i < n;
    const unsigned b = valid ? __ldg(bits + i) : 0u;
    const bool hit = valid && ((b & hi_mask) == prefix);
    const unsigned key = hit ? ((b >> shift) & 0xFFu) : 0x100u;
    const unsigned peers = __match_any_sync(kFull, key);
    if (hit && lane == __ffs(peers) - 1) {
      atomicAdd(&sh[key], (unsigned)__popc(peers));
    }
    if (pass == 0 && valid) {
      const float f = __uint_as_float(b);
      lsum += f;
      lmax = fmaxf(lmax, f);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kBins; i += blockDim.x) {
    if (sh[i]) atomicAdd(&hist[pass * kBins + i], sh[i]);
  }
  if (pass == 0) {
    block_sum_max(&lsum, &lmax);
    if (threadIdx.x == 0) {
      part_sum[blockIdx.x] = lsum;
      part_max[blockIdx.x] = lmax;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
radix_finalize_kernel(const unsigned* __restrict__ hist,
                      const int* __restrict__ rank_ptr, long long n,
                      const float* __restrict__ part_sum,
                      const float* __restrict__ part_max, int nparts,
                      float* out) {
  const int row = blockIdx.x;
  hist += row * kPasses * kBins;
  rank_ptr += row;
  part_sum += (long long)row * nparts;
  part_max += (long long)row * nparts;
  out += 3 * row;
  float s = 0.f, m = 0.f;
  for (int i = threadIdx.x; i < nparts; i += blockDim.x) {
    s += part_sum[i];
    m = fmaxf(m, part_max[i]);
  }
  block_sum_max(&s, &m);
  if (threadIdx.x < 32) {
    unsigned prefix, rest;
    resolve_prefix(hist, kPasses, clamp_rank(rank_ptr, n), &prefix, &rest);
    if (threadIdx.x == 0) {
      out[0] = __uint_as_float(prefix);
      out[1] = m;
      out[2] = s;
    }
  }
}

}  // namespace

extern "C" long long atq_order_stat_scratch_words(int grid, int rows) {
  return (long long)rows * (kPasses * kBins + 2 * grid);
}

// x: rows x n non-negative floats on the device (row-major); rank: one int32
// per row on the device; out: rows x 3 floats [stat, max, sum]; scratch:
// atq_order_stat_scratch_words(grid, rows) 32-bit words. `grid` blocks work
// on each row. Launches on `stream` and does not synchronise. Returns the
// cudaError_t of the launches.
extern "C" int atq_order_stat(int device, const float* x, long long n,
                              int rows, const int* rank, float* out,
                              unsigned* scratch, int grid, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const long long hist_words = (long long)rows * kPasses * kBins;
  unsigned* hist = scratch;
  float* part_sum = reinterpret_cast<float*>(scratch + hist_words);
  float* part_max = part_sum + (long long)rows * grid;
  err = cudaMemsetAsync(hist, 0, hist_words * sizeof(unsigned), s);
  if (err != cudaSuccess) return (int)err;
  const unsigned* bits = reinterpret_cast<const unsigned*>(x);
  const dim3 hist_grid(grid, rows);
  for (int p = 0; p < kPasses; ++p) {
    radix_hist_kernel<<<hist_grid, kThreads, 0, s>>>(bits, n, rank, hist,
                                                     part_sum, part_max, p);
  }
  radix_finalize_kernel<<<rows, kThreads, 0, s>>>(hist, rank, n, part_sum,
                                                  part_max, grid, out);
  return (int)cudaGetLastError();
}
