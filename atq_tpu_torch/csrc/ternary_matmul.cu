// Matmuls straight from 2-bit ternary planes, one tiled kernel for three
// layouts:
//   out[m, n] = scale * sum_k x[m, k] * decode(W)[n, k] (+ the RPB term)
// symmetric (decode -1/0/+1, scale = alpha) or TTQ (+1 -> alpha_p,
// -1 -> -alpha_n, no final scale).
//
// tiled_packed_kernel<Decode, kRpb> replaces four Pallas TPU kernels of
// atq_tpu/ops/ternary_matmul.py:
//   - _kernel (through _pallas_matmul) and _kernel_kblocked (through
//     _pallas_matmul_kblocked): x @ decode(uint8 planes)^T * alpha over the
//     planar layout (core/packing.py:pack_planar: K padded to a multiple of
//     512 and split into 4 quarters of kq = K_pad/4 bytes; byte b of a row
//     holds the codes 00 = -1, 01 = 0, 10 = +1 of columns b, kq+b, 2kq+b,
//     3kq+b in bits 0-1, 2-3, 4-5, 6-7). On the TPU the K axis is held whole
//     in VMEM or walked as a grid axis; here every block walks its K range,
//     so one kernel covers both;
//   - _kernel32 (through _pallas_matmul32): the same over the planar32
//     layout (core/packing.py:pack_planar32: K padded to a multiple of
//     2048, bit field f of word j holds column f*k16 + j);
//   - _kernel_rpb (through _pallas_matmul_rpb): x @ (decode(uint8 planes) *
//     alpha + corr)^T with the dense (N, K) bf16 RPB correction, kept as two
//     f32 sums as the TPU kernel keeps them: the ternary dot is scaled by
//     alpha at the end and the correction dot is added after it.
//
// Design: an ordinary shared-memory f32 GEMM. A block owns a 64 x 64 output
// tile (256 threads, 4 x 4 outputs each, rows ty + 16i and columns tx + 16j
// so the shared-memory reads are broadcast or conflict-free) and walks K in
// tiles of 32 logical columns. Where the output tiles alone would leave most
// of the 132 SMs idle (small M, as at serving batches), K is split over
// gridDim.z blocks: each writes its partial sums (the ternary and the
// correction sums apart) to a workspace, and a second kernel adds the
// splits in a fixed order, then scales and adds as above, so results repeat
// run to run. Each K tile stages x (64 x 32) and the weight tile decoded
// to f32 (64 x 32; and the correction widened from bf16 for RPB) in shared
// memory. Because K_pad/16 (planar32) and K_pad/4 (uint8 planes) are
// multiples of 128, a 32-column tile lies inside one bit field: the field
// is found once per tile, and neighbouring threads read neighbouring words
// or bytes. The walk stops at the logical K, so the 2048-column padding of
// planar32 (10.7x at K = 192) costs nothing, and columns past K, rows past M
// and weight rows past N are masked (no padded copies of x, no
// PLANAR32_ZERO_WORD rows needed).
//
// Bound: at the retrieval text tower's shapes (M = 1600 rows, K and N of
// 192 or 384) the product is 2*M*N*K = 118-236 MFLOP of f32, 1.8-3.5 us at
// the 67 TFLOP/s non-tensor-core f32 rate, against 1.2-2.5 MB of x: it is
// bound by operations. With the RPB correction (2 bytes a weight against
// 0.25 for the planes) and small M it is bound by bytes. This kernel is far
// from both (PERF.md): each thread issues 8 shared-memory loads for 16 FMAs
// (32 with RPB) and decodes 8 weights a tile, and at small K a block's few
// tiles each wait on their global loads, with no load of the next tile in
// flight. A version with float4 reads of K-major tiles and 32 x 64 tiles of
// 128 threads measured slower: each thread then decoded 16 weights a tile,
// and the loads and decodes, not the inner loop, set the time. Larger
// register tiles per thread (8 x 8), loads of the next tile overlapping the
// current one, then TF32/bf16 tensor cores behind their own tolerance, are
// the next steps.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 32;
constexpr int kThreads = 256;
constexpr int kSMs = 132;  // H100 SXM

// A decoder reads the 2-bit code of weight (n, column c). A 32-column K tile
// lies inside one bit field, so the kernel asks for the field once per tile
// (field(k0)) and then decodes with it, with no division per weight.
struct DecodeU8 {  // pack_planar: 4 fields a byte, quarter s at s*kq
  const uint8_t* p;
  int kq;
  __device__ __forceinline__ int field(int c) const { return c / kq; }
  __device__ __forceinline__ float operator()(int n, int c, int f) const {
    const unsigned byte = __ldg(p + (size_t)n * kq + (c - f * kq));
    return (float)((byte >> (2 * f)) & 0x3u) - 1.0f;
  }
};

struct DecodeI32 {  // pack_planar32: 16 fields a word, field f at f*k16
  const int32_t* p;
  int k16;
  __device__ __forceinline__ int field(int c) const { return c / k16; }
  __device__ __forceinline__ float operator()(int n, int c, int f) const {
    const unsigned word = (unsigned)__ldg(p + (size_t)n * k16 + (c - f * k16));
    return (float)((word >> (2 * f)) & 0x3u) - 1.0f;
  }
};

// out: (M, N) when gridDim.z == 1; otherwise the (2, splits, M, N)
// workspace of partial sums (ternary, then correction) for split_reduce.
template <class Decode, bool kRpb>
__global__ void __launch_bounds__(kThreads)
tiled_packed_kernel(const float* __restrict__ x, Decode dec,
                    const uint16_t* __restrict__ corr,
                    const float* __restrict__ alpha, float* __restrict__ out,
                    int M, int N, int K, int k_split, int asym) {
  __shared__ float xs[kBM][kBK + 1];
  __shared__ float ws[kBN][kBK + 1];
  __shared__ float cs[kBN][kBK + 1];  // the correction tile (RPB only)
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const float a_p = __ldg(alpha), a_n = __ldg(alpha + 1);
  float acc[4][4], acc_c[4][4];  // ternary dot; correction dot (RPB)
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = acc_c[i][j] = 0.f;
  const int lc = tid & 31, lr = tid >> 5;  // loader: column, first row
  const int k_end = min(K, (int)(blockIdx.z + 1) * k_split);
  for (int k0 = blockIdx.z * k_split; k0 < k_end; k0 += kBK) {
    const int c = k0 + lc, f = dec.field(k0);
#pragma unroll
    for (int r = lr; r < kBM; r += kThreads / 32) {
      const int m = m0 + r;
      xs[r][lc] = (m < M && c < k_end) ? __ldg(x + (size_t)m * K + c) : 0.f;
    }
#pragma unroll
    for (int r = lr; r < kBN; r += kThreads / 32) {
      const int n = n0 + r;
      float w = 0.f;
      if (n < N && c < k_end) {
        w = dec(n, c, f);
        if (asym) w = a_p * fmaxf(w, 0.f) + a_n * fminf(w, 0.f);
      }
      ws[r][lc] = w;
      if constexpr (kRpb) {
        cs[r][lc] = (n < N && c < k_end)
            ? __uint_as_float((unsigned)__ldg(corr + (size_t)n * K + c) << 16)
            : 0.f;
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[ty + 16 * i][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[tx + 16 * j][kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      if constexpr (kRpb) {
        float d[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) d[j] = cs[tx + 16 * j][kk];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc_c[i][j] = fmaf(a[i], d[j], acc_c[i][j]);
      }
    }
    __syncthreads();
  }
  const bool split = gridDim.z > 1;
  const size_t plane = (size_t)M * N, part = blockIdx.z * plane;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      const size_t o = (size_t)m * N + n;
      if (split) {
        out[part + o] = acc[i][j];
        if constexpr (kRpb) out[gridDim.z * plane + part + o] = acc_c[i][j];
      } else {
        float v = asym ? acc[i][j] : acc[i][j] * a_p;
        if constexpr (kRpb) v += acc_c[i][j];
        out[o] = v;
      }
    }
  }
}

// Sums the splits' partials in split order: out = (sum of the ternary
// partials) * alpha (unless asym) + (sum of the correction partials, RPB).
__global__ void split_reduce(const float* __restrict__ ws,
                             const float* __restrict__ alpha,
                             float* __restrict__ out, int MN, int splits,
                             int asym, int rpb) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= MN) return;
  float t = 0.f, c = 0.f;
  for (int s = 0; s < splits; ++s) t += ws[(size_t)s * MN + o];
  float v = asym ? t : t * __ldg(alpha);
  if (rpb) {
    for (int s = 0; s < splits; ++s) c += ws[(size_t)(splits + s) * MN + o];
    v += c;
  }
  out[o] = v;
}

// K tiles a split: split K only where the output tiles fill less than one
// block per SM, and keep at least 4 K tiles per split.
int choose_k_split(int M, int N, int K) {
  const int tiles = ((N + kBN - 1) / kBN) * ((M + kBM - 1) / kBM);
  const int k_tiles = (K + kBK - 1) / kBK;
  int splits = 1;
  if (tiles < kSMs) splits = min((kSMs + tiles - 1) / tiles, k_tiles / 4);
  splits = max(splits, 1);
  return ((k_tiles + splits - 1) / splits) * kBK;
}

template <class Decode, bool kRpb>
int launch_tiled(const float* x, Decode dec, const uint16_t* corr,
                 const float* alpha, float* out, float* ws, int M, int N,
                 int K, int asym, cudaStream_t stream) {
  const int k_split = choose_k_split(M, N, K);
  const int splits = (K + k_split - 1) / k_split;
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
  tiled_packed_kernel<Decode, kRpb><<<grid, kThreads, 0, stream>>>(
      x, dec, corr, alpha, splits > 1 ? ws : out, M, N, K, k_split, asym);
  if (splits > 1) {
    const int MN = M * N;
    split_reduce<<<(MN + 255) / 256, 256, 0, stream>>>(ws, alpha, out, MN,
                                                       splits, asym, kRpb);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Floats of workspace the launches below need for (M, N, K): the split-K
// partials, 0 when K is not split.
extern "C" long long atq_packed_workspace_floats(int M, int N, int K) {
  const int k_split = choose_k_split(M, N, K);
  const int splits = (K + k_split - 1) / k_split;
  return splits > 1 ? 2LL * splits * M * N : 0;
}

// x: (M, K) f32 row-major; planes: (N, kq) uint8 planar planes, 4*kq >= K;
// alpha: 2 floats [alpha, alpha] (symmetric) or [alpha_p, alpha_n] (TTQ,
// asym = 1); out: (M, N) f32; ws: atq_packed_workspace_floats(M, N, K)
// floats (may be null when 0). Each entry point launches on `stream`, does
// not synchronise, and returns the cudaError_t of the launch.
extern "C" int atq_ternary_matmul(int device, const float* x,
                                  const uint8_t* planes, const float* alpha,
                                  float* out, float* ws, int M, int N, int K,
                                  int kq, int asym, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return launch_tiled<DecodeU8, false>(x, DecodeU8{planes, kq}, nullptr,
                                       alpha, out, ws, M, N, K, asym,
                                       (cudaStream_t)stream);
}

// x: (M, K) f32; planes: (N, k16) int32 planar32 words, 16*k16 >= K;
// alpha: [alpha, alpha] or [alpha_p, alpha_n] (asym = 1); out: (M, N) f32;
// ws: atq_packed_workspace_floats(M, N, K) floats (may be null when 0).
extern "C" int atq_ternary_matmul32(int device, const float* x,
                                    const int32_t* planes, const float* alpha,
                                    float* out, float* ws, int M, int N,
                                    int K, int k16, int asym, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return launch_tiled<DecodeI32, false>(x, DecodeI32{planes, k16}, nullptr,
                                        alpha, out, ws, M, N, K, asym,
                                        (cudaStream_t)stream);
}

// x: (M, K) f32; planes: (N, kq) uint8 planar planes, 4*kq >= K; corr:
// (N, K) bf16 bits, unpadded; alpha: [alpha, alpha]; out: (M, N) f32 =
// (x @ decode^T) * alpha + x @ corr^T; ws as above.
extern "C" int atq_ternary_matmul_rpb(int device, const float* x,
                                      const uint8_t* planes,
                                      const uint16_t* corr, const float* alpha,
                                      float* out, float* ws, int M, int N,
                                      int K, int kq, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return launch_tiled<DecodeU8, true>(x, DecodeU8{planes, kq}, corr, alpha,
                                      out, ws, M, N, K, 0,
                                      (cudaStream_t)stream);
}
