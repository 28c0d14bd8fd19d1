// Matmuls straight from 2-bit ternary planes on the tensor cores, one tiled
// kernel for three layouts:
//   out[m, n] = scale * sum_k x[m, k] * decode(W)[n, k] (+ the RPB term)
// symmetric (decode -1/0/+1, scale = alpha) or TTQ (+1 -> alpha_p,
// -1 -> -alpha_n).
//
// tiled_packed_kernel<Decode, kMode> replaces four Pallas TPU kernels of
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
// Precision: a decoded weight (-1, 0, +1) and the bf16 correction are exact
// bf16 values. x is split into three bf16 terms, x = x0 + x1 + x2, each the
// bf16 rounding of what the earlier terms left (exact for normal floats:
// 8 + 8 + 8 bits of the 24-bit significand). Each product x_i * w is then
// exact and mma.sync (m16n8k16, bf16 in, f32 accumulate) sums it in f32, so
// the result is an f32 product up to the order of the sums: no TF32 or bf16
// loss. TTQ multiplies the indicator planes [w = +1] and [w = -1] into two
// accumulators and finishes with alpha_p * S+ - alpha_n * S- (alpha_p and
// alpha_n are not bf16 values); RPB keeps the ternary accumulator and the
// correction accumulator apart and reads the correction's bf16 bits
// straight into the B operand.
//
// Bound: at every main-path shape the least time is set by bytes (x read
// and out written, 4 bytes each; 2 bits a weight; 2 bytes a correction
// weight): at the text tower (M = 1600, K and N of 96-384) 2.5-3.7 MB, 0.7-
// 1.1 us at 3.35 TB/s, against 6*M*N*K bf16 operations (three passes),
// 0.2-0.7 us at 989 TFLOP/s; RPB's two products (12*M*N*K) are as long as
// the bytes at 192->192 and longer at 192->384 and 384->192. At serving's
// small M (1-32) the planes and the launch set the time.
//
// Design: a block of 4 warps owns a 32 x 32 output tile and walks its K
// range in tiles of 64 columns; warp w takes columns 16w..16w+15 of every
// tile, for the whole 32 x 32 tile (K split across the warps of the block),
// and the four partial tiles are added in shared memory in warp order at
// the end. So each x element of a tile is split into its bf16 terms once
// and each weight decoded once, by the one thread whose fragment holds it.
// RPB's warps are 2 along M x 2 along K (16 rows and 32 columns of every
// tile each; its weights are decoded twice) and it is held to 168 registers
// a thread: over the whole tile its two accumulators took 252, 2 blocks an
// SM (PERF.md has the variants' times).
// The 16 columns of an m16n8k16 step are taken in a permuted order (thread
// t's fragment slots 2t, 2t+1, 2t+8, 2t+9 hold the adjacent columns 4t..4t+3,
// the same for A and B, which leaves the sum unchanged), so a thread reads
// its x as one float4 a row and its weights as one 32-bit word (uint8
// planes: 4 bytes) or one 128-bit load (planar32: 4 words), and decodes four
// codes to bf16 with a byte permute from a table. A ring of 3 stages in
// shared memory is filled by 16-byte cp.async copies (zero-filled past M,
// N and K; element copies where a row is not 16-byte aligned): the copies
// of tile i + 2 are issued before tile i's MMAs, one barrier a tile.
// Shared-memory tiles are XOR-swizzled by 16-byte chunk so each fragment
// load is conflict-free. Because K_pad/16 (planar32) and K_pad/4 (uint8
// planes) are multiples of 128, a 64-column tile lies inside one bit field:
// the field is found once per tile; planar32 words are shifted
// arithmetically and masked, so bit 31 (a +1 in field 15) is no sign. The
// walk stops at the logical K (the 2048-column padding of planar32 costs
// nothing) and reads no padded x. 32 x 32 tiles give the text tower 150-600
// blocks on 132 SMs; where the output tiles leave SMs idle and K is 8 tiles
// or more (the image projector's 512, the classifier head's 3136, 8704; at
// 512 the split took 0.0083 ms to 0.0053, PERF.md), K is also split across
// blocks, each writes its partial sums to a workspace and a second kernel
// adds them in split order. There are no atomics: the same inputs give the
// same bits, run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 32, kBN = 32, kBK = 64;  // output tile; K tile
constexpr int kWarps = 4, kThreads = 32 * kWarps;
constexpr int kStages = 3;
constexpr int kSMs = 132;             // H100 SXM
constexpr int kSplitMinKTiles = 8;    // split K across blocks from here

enum Mode { kSym = 0, kTtq = 1, kRpb = 2 };

// bf16 bits of code c (0, 1, 2 -> -1, 0, +1; 3 unused) as byte tables for
// __byte_perm: byte c of kHi* is the high byte, of kLo* the low byte.
constexpr uint32_t kHiW = 0x003F00BFu, kLoW = 0x00800080u;    // w
constexpr uint32_t kHiPos = 0x003F0000u, kLoPos = 0x00800000u;  // [w = +1]
constexpr uint32_t kHiNeg = 0x0000003Fu, kLoNeg = 0x00000080u;  // [w = -1]

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// A shared-memory tile of 32 rows x kBK elements of kElem bytes, stored in
// 16-byte chunks; chunk c of row r sits at chunk swz(r, c) of its row, so
// the fragment loads below (float4 / 128-bit rows r, r+1 per 8 lanes; 32-bit
// words of 8 rows; 64-bit words of 4 rows per 16 lanes) hit distinct banks.
template <int kElem>
struct Tile {
  static constexpr int kChunks = kBK * kElem / 16;
  static constexpr int kBytes = 32 * kBK * kElem;
  __device__ __forceinline__ static int swz(int r, int c) {
    if constexpr (kElem == 4) return c ^ ((r & 1) << 2);
    else if constexpr (kElem == 2) return c ^ ((r & 3) << 1);
    else return c ^ ((r >> 1) & 3);
  }
  __device__ __forceinline__ static int offset(int r, int col) {
    const int b = col * kElem;
    return (r * kChunks + swz(r, b >> 4)) * 16 + (b & 15);
  }
};

// Copies rows [0, rows) x columns [0, cols) of a tile from g (row stride
// ld bytes) into s, zeros elsewhere: 16-byte cp.async where every row is
// 16-byte aligned (vec), else element copies.
template <int kElem>
__device__ __forceinline__ void load_tile(unsigned char* s,
                                          const unsigned char* g, size_t ld,
                                          int rows, int cols, bool vec,
                                          int tid) {
  using T = Tile<kElem>;
  if (vec) {
    for (int q = tid; q < 32 * T::kChunks; q += kThreads) {
      const int r = q / T::kChunks, c = q % T::kChunks;
      const int bytes = r < rows ? min(max(cols * kElem - c * 16, 0), 16) : 0;
      cp_async16(s + (r * T::kChunks + T::swz(r, c)) * 16,
                 bytes ? g + r * ld + c * 16 : g, bytes);
    }
    return;
  }
  for (int e = tid; e < 32 * kBK; e += kThreads) {
    const int r = e / kBK, col = e % kBK;
    const bool ok = r < rows && col < cols;
    unsigned char* d = s + T::offset(r, col);
    const unsigned char* src = g + r * ld + col * kElem;
    if constexpr (kElem == 4)
      *(uint32_t*)d = ok ? __ldg((const unsigned*)src) : 0u;
    else if constexpr (kElem == 2)
      *(uint16_t*)d = ok ? __ldg((const unsigned short*)src) : 0;
    else
      *d = ok ? __ldg(src) : 0;
  }
}

// A decoder names a K tile's bit field (a 64-column tile lies inside one),
// where its rows start, and reads the codes of the 4 weights at columns
// col..col+3 of a staged row, one code a byte (bits 0-1).
struct DecodeU8 {  // pack_planar: 4 fields a byte, quarter s at s*kq
  static constexpr int kElem = 1;
  const uint8_t* p;
  int kq;
  __device__ __forceinline__ int field(int c) const { return c / kq; }
  __device__ __forceinline__ const unsigned char* tile(int n0, int k0,
                                                      int f) const {
    return p + (size_t)n0 * kq + (k0 - f * kq);
  }
  __device__ __forceinline__ size_t ld() const { return (size_t)kq; }
  __device__ __forceinline__ static uint32_t codes(const unsigned char* s,
                                                   int r, int col, int f) {
    const uint32_t w = *(const uint32_t*)(s + Tile<1>::offset(r, col));
    return (w >> (2 * f)) & 0x03030303u;
  }
};

struct DecodeI32 {  // pack_planar32: 16 fields a word, field f at f*k16
  static constexpr int kElem = 4;
  const int32_t* p;
  int k16;
  __device__ __forceinline__ int field(int c) const { return c / k16; }
  __device__ __forceinline__ const unsigned char* tile(int n0, int k0,
                                                      int f) const {
    return (const unsigned char*)(p + (size_t)n0 * k16 + (k0 - f * k16));
  }
  __device__ __forceinline__ size_t ld() const { return (size_t)k16 * 4; }
  __device__ __forceinline__ static uint32_t codes(const unsigned char* s,
                                                   int r, int col, int f) {
    const int4 w = *(const int4*)(s + Tile<4>::offset(r, col));
    // arithmetic shift, then mask: field 15's bit 31 is no sign here
    const uint32_t lo = __byte_perm((w.x >> (2 * f)) & 3, (w.y >> (2 * f)) & 3,
                                    0x0040);
    const uint32_t hi = __byte_perm((w.z >> (2 * f)) & 3, (w.w >> (2 * f)) & 3,
                                    0x0040);
    return __byte_perm(lo, hi, 0x5410);
  }
};

// Two bf16 values from two codes (bits 0-1 and 8-9 of c2), the lower
// column in the low half: result bytes lo[c0], hi[c0], lo[c1], hi[c1].
__device__ __forceinline__ uint32_t bf16_pair(uint32_t c2, uint32_t hi,
                                              uint32_t lo) {
  return __byte_perm(hi, lo, c2 * 0x11u + 0x0404u);
}

// (lo, hi) = t[0] + t[1] + t[2], each term a bf16 pair: the bf16 rounding
// of what the terms before it left.
__device__ __forceinline__ void split3(float lo, float hi, uint32_t (&t)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
    t[i] = *reinterpret_cast<const uint32_t*>(&b);
    const float2 f = __bfloat1622float2(b);
    lo -= f.x;
    hi -= f.y;
  }
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// out from the accumulators' sums: S * alpha; alpha_p * S+ - alpha_n * S-;
// S * alpha + C.
template <int kMode>
__device__ __forceinline__ float finish(const float (&v)[2], float a_p,
                                        float a_n) {
  if constexpr (kMode == kSym) return v[0] * a_p;
  else if constexpr (kMode == kTtq) return a_p * v[0] - a_n * v[1];
  else return v[0] * a_p + v[1];
}

// out: (M, N) when gridDim.z == 1; otherwise the (accumulators, splits, M,
// N) workspace of partial sums for split_reduce. vec: bit 0 x, bit 1 the
// planes, bit 2 the correction have 16-byte aligned rows. RPB is held to 3
// blocks an SM (168 registers, a few spilled): left alone it took 202.
template <class Decode, int kMode>
__global__ void __launch_bounds__(kThreads, kMode == kRpb ? 3 : 1)
tiled_packed_kernel(const float* __restrict__ x, Decode dec,
                    const uint16_t* __restrict__ corr,
                    const float* __restrict__ alpha, float* __restrict__ out,
                    int M, int N, int K, int k_split, int vec) {
  constexpr int kAcc = kMode == kSym ? 1 : 2;
  // Warps: kWM along M (kMT m16 tiles each) x kWK along K (kKS k16 steps of
  // every K tile each); RPB's split M in two (see the note at the top).
  constexpr int kWM = kMode == kRpb ? 2 : 1, kWK = kWarps / kWM;
  constexpr int kMT = 2 / kWM, kKS = 4 / kWK;
  constexpr int kXBytes = Tile<4>::kBytes;
  constexpr int kWBytes = Tile<Decode::kElem>::kBytes;
  constexpr int kCBytes = kMode == kRpb ? Tile<2>::kBytes : 0;
  constexpr int kStage = kXBytes + kWBytes + kCBytes;
  constexpr int kRedLd = kBN + 8;  // floats a row of a warp's partial tile
  constexpr int kRedBytes = kAcc * kWK * kBM * kRedLd * 4;
  constexpr int kSmem =
      kStages * kStage > kRedBytes ? kStages * kStage : kRedBytes;
  __shared__ __align__(16) unsigned char smem[kSmem];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / kWK, wk = warp % kWK;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int k_begin = blockIdx.z * k_split;
  const int k_end = min(K, k_begin + k_split);
  const int n_tiles = (k_end - k_begin + kBK - 1) / kBK;
  const int rows_x = min(kBM, M - m0), rows_w = min(kBN, N - n0);

  auto issue = [&](int i) {
    if (i < n_tiles) {
      unsigned char* s = smem + (i % kStages) * kStage;
      const int k0 = k_begin + i * kBK, cols = min(kBK, k_end - k0);
      load_tile<4>(s, (const unsigned char*)(x + (size_t)m0 * K + k0),
                   (size_t)K * 4, rows_x, cols, vec & 1, tid);
      load_tile<Decode::kElem>(s + kXBytes, dec.tile(n0, k0, dec.field(k0)),
                               dec.ld(), rows_w, kBK, vec & 2, tid);
      if constexpr (kMode == kRpb)
        load_tile<2>(s + kXBytes + kWBytes,
                     (const unsigned char*)(corr + (size_t)n0 * K + k0),
                     (size_t)K * 2, rows_w, cols, vec & 4, tid);
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };

  float acc[kAcc][kMT][4][4] = {};  // [accumulator][m16 tile][n8 tile][frag]
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kStages - 2>();  // tile i has landed (this thread's part)
    __syncthreads();  // ... everyone's; and tile i - 1's stage is free
    issue(i + kStages - 1);
    const unsigned char* s = smem + (i % kStages) * kStage;
    const int f = dec.field(k_begin + i * kBK);
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
      const int col = 16 * (wk * kKS + ks) + 4 * t;  // this thread's columns
      // A: rows g and g + 8 of this warp's m16 tiles, three bf16 terms each.
      uint32_t a[3][kMT][4];
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi) {
        const int r = 16 * (wm * kMT + mi) + g;
        const float4 lo = *(const float4*)(s + Tile<4>::offset(r, col));
        const float4 hi = *(const float4*)(s + Tile<4>::offset(r + 8, col));
        uint32_t q0[3], q1[3], q2[3], q3[3];
        split3(lo.x, lo.y, q0);
        split3(hi.x, hi.y, q1);
        split3(lo.z, lo.w, q2);
        split3(hi.z, hi.w, q3);
#pragma unroll
        for (int e = 0; e < 3; ++e) {
          a[e][mi][0] = q0[e];
          a[e][mi][1] = q1[e];
          a[e][mi][2] = q2[e];
          a[e][mi][3] = q3[e];
        }
      }
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const int r = 8 * nj + g;
        const uint32_t c = Decode::codes(s + kXBytes, r, col, f);
        const uint32_t c01 = c & 0x0303u, c23 = (c >> 16) & 0x0303u;
        uint32_t b[kAcc][2];
        if constexpr (kMode == kTtq) {
          b[0][0] = bf16_pair(c01, kHiPos, kLoPos);
          b[0][1] = bf16_pair(c23, kHiPos, kLoPos);
          b[kAcc - 1][0] = bf16_pair(c01, kHiNeg, kLoNeg);
          b[kAcc - 1][1] = bf16_pair(c23, kHiNeg, kLoNeg);
        } else {
          b[0][0] = bf16_pair(c01, kHiW, kLoW);
          b[0][1] = bf16_pair(c23, kHiW, kLoW);
          if constexpr (kMode == kRpb) {
            const uint2 cv = *(const uint2*)(s + kXBytes + kWBytes +
                                             Tile<2>::offset(r, col));
            b[kAcc - 1][0] = cv.x;
            b[kAcc - 1][1] = cv.y;
          }
        }
#pragma unroll
        for (int q = 0; q < kAcc; ++q)
#pragma unroll
          for (int e = 0; e < 3; ++e)
#pragma unroll
            for (int mi = 0; mi < kMT; ++mi)
              mma(acc[q][mi][nj], a[e][mi], b[q][0], b[q][1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring becomes the warps' partial tiles

  float* red = reinterpret_cast<float*>(smem);  // [acc][wk][kBM][kRedLd]
#pragma unroll
  for (int q = 0; q < kAcc; ++q)
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const int r = 16 * (wm * kMT + mi) + g;
        float* p = red + ((q * kWK + wk) * kBM + r) * kRedLd + 8 * nj + 2 * t;
        const float* d = acc[q][mi][nj];
        *(float2*)p = make_float2(d[0], d[1]);
        *(float2*)(p + 8 * kRedLd) = make_float2(d[2], d[3]);
      }
  __syncthreads();
  const float a_p = __ldg(alpha), a_n = __ldg(alpha + 1);
  const size_t plane = (size_t)M * N;
  for (int e = tid; e < kBM * kBN; e += kThreads) {
    const int r = e / kBN, c = e % kBN, m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) continue;
    float v[2] = {0.f, 0.f};
#pragma unroll
    for (int q = 0; q < kAcc; ++q) {
      const float* p = red + (q * kWK * kBM + r) * kRedLd + c;
      float sum = p[0];
#pragma unroll
      for (int w = 1; w < kWK; ++w) sum += p[w * kBM * kRedLd];
      v[q] = sum;
    }
    const size_t o = (size_t)m * N + n;
    if (gridDim.z > 1) {
#pragma unroll
      for (int q = 0; q < kAcc; ++q)
        out[(q * gridDim.z + blockIdx.z) * plane + o] = v[q];
    } else {
      out[o] = finish<kMode>(v, a_p, a_n);
    }
  }
}

// Adds the splits' partials in split order, then finishes as above.
template <int kMode>
__global__ void split_reduce(const float* __restrict__ ws,
                             const float* __restrict__ alpha,
                             float* __restrict__ out, int MN, int splits) {
  constexpr int kAcc = kMode == kSym ? 1 : 2;
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= MN) return;
  float v[2] = {0.f, 0.f};
#pragma unroll
  for (int q = 0; q < kAcc; ++q)
    for (int s = 0; s < splits; ++s)
      v[q] += ws[(size_t)(q * splits + s) * MN + o];
  out[o] = finish<kMode>(v, __ldg(alpha), __ldg(alpha + 1));
}

// K columns a split (a multiple of kBK): split K across blocks only where
// the output tiles leave SMs idle and K is long, keeping 2 K tiles a split
// at least.
int choose_k_split(int M, int N, int K) {
  const int tiles = ((N + kBN - 1) / kBN) * ((M + kBM - 1) / kBM);
  const int k_tiles = (K + kBK - 1) / kBK;
  int splits = 1;
  if (tiles < kSMs && k_tiles >= kSplitMinKTiles)
    splits = min((kSMs + tiles - 1) / tiles, k_tiles / 2);
  splits = max(splits, 1);
  return ((k_tiles + splits - 1) / splits) * kBK;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <class Decode, int kMode>
int launch_tiled(const float* x, Decode dec, const uint16_t* corr,
                 const float* alpha, float* out, float* ws, int M, int N,
                 int K, cudaStream_t stream) {
  const int k_split = choose_k_split(M, N, K);
  const int splits = (K + k_split - 1) / k_split;
  const int vec = (K % 4 == 0 && aligned16(x) ? 1 : 0) |
                  (aligned16(dec.p) ? 2 : 0) |
                  (K % 8 == 0 && aligned16(corr) ? 4 : 0);
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
  tiled_packed_kernel<Decode, kMode><<<grid, kThreads, 0, stream>>>(
      x, dec, corr, alpha, splits > 1 ? ws : out, M, N, K, k_split, vec);
  if (splits > 1) {
    const int MN = M * N;
    split_reduce<kMode><<<(MN + 255) / 256, 256, 0, stream>>>(ws, alpha, out,
                                                              MN, splits);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Floats of workspace the launches below need for (M, N, K): the split-K
// partials of up to two accumulators, 0 when K is not split.
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
  const DecodeU8 dec{planes, kq};
  return asym ? launch_tiled<DecodeU8, kTtq>(x, dec, nullptr, alpha, out, ws,
                                             M, N, K, (cudaStream_t)stream)
              : launch_tiled<DecodeU8, kSym>(x, dec, nullptr, alpha, out, ws,
                                             M, N, K, (cudaStream_t)stream);
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
  const DecodeI32 dec{planes, k16};
  return asym ? launch_tiled<DecodeI32, kTtq>(x, dec, nullptr, alpha, out, ws,
                                              M, N, K, (cudaStream_t)stream)
              : launch_tiled<DecodeI32, kSym>(x, dec, nullptr, alpha, out, ws,
                                              M, N, K, (cudaStream_t)stream);
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
  return launch_tiled<DecodeU8, kRpb>(x, DecodeU8{planes, kq}, corr, alpha,
                                      out, ws, M, N, K, (cudaStream_t)stream);
}
