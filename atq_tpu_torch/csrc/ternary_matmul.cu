// Matmul straight from planar 2-bit ternary planes:
//   out[m, n] = scale * sum_k x[m, k] * decode(W)[n, k]
// symmetric (decode -1/0/+1, scale = alpha) or TTQ (+1 -> alpha_p,
// -1 -> -alpha_n, no final scale).
//
// Replaces the Pallas TPU kernels atq_tpu/ops/ternary_matmul.py:_kernel
// (through _pallas_matmul) and :_kernel_kblocked (through
// _pallas_matmul_kblocked). On the TPU the K axis is either held whole in
// VMEM or walked as a sequential grid axis with the output block revisited;
// here every warp loops over all of K itself, so one kernel covers both.
//
// Planar layout (core/packing.py:pack_planar): K is padded to K_pad, a
// multiple of 512, and split into 4 quarters of kq = K_pad/4 bytes; byte b
// of a row holds the 2-bit codes (00 = -1, 01 = 0, 10 = +1) of columns
// b, kq+b, 2kq+b, 3kq+b in bits 0-1, 2-3, 4-5, 6-7.
//
// Design: one warp owns one weight row n and a tile of up to kTileM rows of
// x. Lane l walks bytes l, l+32, ... of the row (32 consecutive bytes per
// warp load), decodes each byte in registers into its 4 values, and adds
// x[m, s*kq+b] * w_s into f32 accumulators; x loads are consecutive across
// the lanes. Columns >= K are skipped and rows >= M or >= N masked, so x
// needs no padded copy. A warp shuffle tree sums the lanes. alpha and
// alpha_n are read from device memory.
//
// Bound: at the serving shapes (M <= 32, N = 128, K = 3136) the kernel must
// move about 115 KB of planes and 400 KB of x, well under 1 us at 3.35 TB/s,
// and do 2*M*N*K = 25.7 MFLOP, under 1 us at the 67 TFLOP/s f32 rate. This
// design is far from both: it fills only 64 blocks there, and each lane runs
// a chain of dependent loads of x with no reuse, so latency sets its time
// (tens of us on an H100, see PERF.md). Staging x in shared memory, splitting
// K over more warps, then tensor cores are the next steps.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;   // weight rows per block
constexpr int kTileM = 8;   // x rows per warp
constexpr unsigned kFull = 0xFFFFFFFFu;

__global__ void __launch_bounds__(kWarps * 32)
ternary_matmul_kernel(const float* __restrict__ x,
                      const uint8_t* __restrict__ planes,
                      const float* __restrict__ alpha,
                      float* __restrict__ out, int M, int N, int K, int kq,
                      int asym) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + warp;
  const int m0 = blockIdx.y * kTileM;
  if (n >= N) return;  // whole warp leaves together
  const float a_p = __ldg(alpha), a_n = __ldg(alpha + 1);
  const int rows = min(kTileM, M - m0);
  const float* xt = x + (size_t)m0 * K;
  const uint8_t* wrow = planes + (size_t)n * kq;

  float acc[kTileM];
#pragma unroll
  for (int i = 0; i < kTileM; ++i) acc[i] = 0.f;

  for (int b = lane; b < kq; b += 32) {
    const unsigned byte = __ldg(wrow + b);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int col = s * kq + b;
      if (col >= K) break;  // later quarters only lie further right
      float w = (float)((byte >> (2 * s)) & 0x3u) - 1.0f;
      if (asym) w = a_p * fmaxf(w, 0.f) + a_n * fminf(w, 0.f);
#pragma unroll
      for (int i = 0; i < kTileM; ++i) {
        if (i < rows) acc[i] = fmaf(__ldg(xt + (size_t)i * K + col), w, acc[i]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kTileM; ++i) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc[i] += __shfl_xor_sync(kFull, acc[i], off);
    }
  }
  if (lane == 0) {
    for (int i = 0; i < rows; ++i) {
      out[(size_t)(m0 + i) * N + n] = asym ? acc[i] : acc[i] * a_p;
    }
  }
}

}  // namespace

// x: (M, K) f32 row-major; planes: (N, kq) uint8 row-major with 4*kq >= K;
// alpha: 2 floats [alpha, alpha] (symmetric) or [alpha_p, alpha_n] (TTQ,
// asym = 1); out: (M, N) f32. Launches on `stream` and does not synchronise.
// Returns the cudaError_t of the launch.
extern "C" int atq_ternary_matmul(int device, const float* x,
                                  const uint8_t* planes, const float* alpha,
                                  float* out, int M, int N, int K, int kq,
                                  int asym, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + kWarps - 1) / kWarps, (M + kTileM - 1) / kTileM);
  ternary_matmul_kernel<<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      x, planes, alpha, out, M, N, K, kq, asym);
  return (int)cudaGetLastError();
}
