// Exact order statistic of a non-negative float32 vector, with its max and
// its sum: (sorted(x)[rank], max(x), sum(x)); or of each row of a stacked
// (L, n) tensor, with one rank per row. One launch a call, whatever L and n.
//
// Replaces the Pallas TPU kernels atq_tpu/ops/order_stat.py:_kernel (reached
// through _pallas_select / order_statistic_reductions) and :_batched_kernel
// (through _pallas_select_batched / order_statistic_reductions_batched). The
// TPU kernels keep a layer's bit matrix in VMEM and run a 31-round bisection
// over it, a grid step a layer. A Hopper SM has 227 KB of shared memory, not
// megabytes, so the design is different: an MSB-first radix select over the
// uint32 bit patterns (non-negative IEEE-754 floats order as their bit
// patterns, so the result is bit-identical to the sort), with digits of 12,
// 10 and 10 bits (4096, 1024 and 1024 bins).
//
// Bound: one read of the 4·L·n input bytes at 3.35 TB/s (0.48 us at the
// classifier's n = 401,408; 8.5 us at (12, 589,824); 34 us at
// (12, 2,359,296)). At the retrieval tower's 18,432-98,304 weights the bound
// is 0.02-0.12 us and the kernel is latency: the launch, the barriers, the
// chain of three digit selections.
//
// Design: one thread block cluster a row, C = 1-16 CTAs of 512 threads, each
// CTA a contiguous segment of its row. The launch picks C (the host side
// below, from the occupancy API): the fewest CTAs that hold a row in shared
// memory (resident), if all rows then run in one wave; else 16 or 8 CTAs a
// row, whichever needs fewer waves.
//   pass 0: each CTA copies its segment (or, for a longer row, its first
//     kStreamHoldWords) from device memory into shared memory, with
//     cp.async (kPipe 16-byte copies in flight a thread) where the row is
//     16-byte aligned, counts digit 0, and sums and maxes in a fixed order.
//   a longer row: the held parts are a sample. One selection over the
//     cluster's merged sample gives a window of digit-0 bins around the
//     rank's place in it; the rest of the segment is streamed once (a ring
//     of cp.async stages): elements below the window counted in registers,
//     those in it counted and kept in shared memory, those above by
//     difference. A window that misses the chosen bin (the same in every
//     CTA) counts digit 0 again over the segment; a CTA whose list
//     overflows counts digits 1 and 2 over its segment, re-read. Both are
//     right, not fast.
//   each digit: the histogram and a 64-bin coarse one in shared memory; a
//     cluster barrier; every CTA reads the coarse histograms of all CTAs
//     through distributed shared memory (16-byte loads), picks the coarse
//     bin that holds the rank, then reads that bin's fine counts from all
//     CTAs: so every CTA finds the same digit with no broadcast and one
//     barrier a digit. Histograms alternate between two buffers, so a CTA
//     can count the next digit while others still read the last one.
//   digit 1 counts over the held row (and a longer row's window list) and
//     keeps the chosen bin's elements in a list; digit 2 counts over that
//     list only (over digit 1's sources again if it overflowed). A list is
//     each thread's own slots (a count in a register: no atomics) and a
//     shared spill for the rest.
// Histograms are integers, so the selected bits are exact whatever order the
// atomics run in. The sum is reduced in one fixed order (each thread's
// elements in index order, each four summed pairwise in float32 into a
// float64 sum, a butterfly in each warp, one over the warps, the CTAs in
// order), so two launches give the same bits. Nothing in global memory needs
// zeroing and there is no scratch: the only buffer is the caller's (L, 3)
// output. The rank is read from device memory: the caller never syncs.
// tests/test_torch_order_stat_select.py holds a numpy model of this plan
// (constants read from this file) against the sort and the JAX kernels.
//
// The design before this one: a memset, four histogram launches over a
// multi-block grid (each re-reading the input and re-deriving the prefix
// from the earlier passes' histograms in device memory) and a finalize
// launch: six stream operations a call; 0.0248 device ms at n = 401,408,
// 0.0928 at (12, 589,824) and 0.4759 at (12, 2,359,296) against this
// kernel's 0.0174, 0.0314 and 0.0772 (NVIDIA H100 80GB HBM3, 700 W;
// `chip_smoke.py --compare`, PERF.md).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // 4-byte loads: kStep in flight a thread
constexpr int kStep = 4 * kUnroll;  // elements a thread a step
constexpr int kPipe = 6;  // 16-byte cp.async copies in flight a thread
constexpr int kFirstBits = 12;  // digit 0: bits 31-20
constexpr int kRestBits = 10;   // digits 1 and 2: bits 19-10 and 9-0
constexpr int kMaxBins = 1 << kFirstBits;
constexpr int kCoarse = 64;     // coarse bins a histogram, for the selection
constexpr int kSelThreads = 256;  // the threads that run the selection
constexpr int kPoolWords = 49152;        // held bit patterns and candidates
constexpr int kHoldWords = 45056;        // a CTA of a resident row holds <=
constexpr int kStreamHoldWords = 12288;  // a CTA of a longer row holds this
constexpr int kRingWords = kPipe * kThreads * 4;  // its stream's staging
constexpr int kWindowDiv = 256;  // window: the held sample's rank +- H/256
constexpr int kWindowPad = 256;  //   + 256
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ unsigned warp_incl_scan(unsigned v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned t = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += t;
  }
  return v;
}

// Sum over each group of 16 lanes, in every lane of the group.
__device__ __forceinline__ uint4 half_warp_sum(uint4 v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    v.x += __shfl_xor_sync(kFull, v.x, off);
    v.y += __shfl_xor_sync(kFull, v.y, off);
    v.z += __shfl_xor_sync(kFull, v.z, off);
    v.w += __shfl_xor_sync(kFull, v.w, off);
  }
  return v;
}

// In each warp: the entry of tot[0, cnt) (cnt <= 64) that holds rank r (below
// the entries' sum), and the rank left inside it. Every warp gets the same.
__device__ __forceinline__ void warp_find(const unsigned* tot, int cnt,
                                          unsigned r, unsigned* idx,
                                          unsigned* rest) {
  const int lane = threadIdx.x & 31;
  const unsigned a = 2 * lane < cnt ? tot[2 * lane] : 0u;
  const unsigned b = 2 * lane + 1 < cnt ? tot[2 * lane + 1] : 0u;
  const unsigned incl = warp_incl_scan(a + b);
  const unsigned ballot = __ballot_sync(kFull, incl > r);
  const int src = ballot ? __ffs(ballot) - 1 : 31;
  const unsigned excl = incl - a - b;
  const bool first = r < excl + a;
  const unsigned i = 2 * lane + (first ? 0 : 1);
  const unsigned rr = r - excl - (first ? 0 : a);
  *idx = __shfl_sync(kFull, i, src);
  *rest = __shfl_sync(kFull, rr, src);
}

struct __align__(16) Select {
  unsigned ctot[kCoarse];  // coarse totals over the cluster
  unsigned ftot[kCoarse];  // fine totals of the chosen coarse bin
};

// The coarse histogram of h (nb bins, 1024 or 4096): kCoarse sums of nb/64
// consecutive bins, four threads a sum. The whole block calls it after h is
// complete.
__device__ __forceinline__ void build_coarse(const unsigned* h, int nb,
                                             unsigned* coarse) {
  if (threadIdx.x >= kSelThreads) return;  // whole warps
  const int per4 = nb / kCoarse / 16;  // uint4 a thread: 4 or 1
  const int g = threadIdx.x >> 2, part = threadIdx.x & 3;
  const uint4* p = reinterpret_cast<const uint4*>(h) + (g * 4 + part) * per4;
  unsigned s = 0;
  for (int i = 0; i < per4; ++i) {
    const uint4 v = p[i];
    s += v.x + v.y + v.z + v.w;
  }
  s += __shfl_xor_sync(kFull, s, 2);
  s += __shfl_xor_sync(kFull, s, 1);
  if (part == 0) coarse[g] = s;
}

// The bin of the cluster-wide sum of every CTA's histogram h (nb bins, with
// its coarse histogram) that holds rank r, and the rank left inside it: the
// coarse totals of all CTAs through distributed shared memory (16-byte
// loads), then the fine bins of the chosen coarse bin (a lone CTA reads its
// own). Every CTA and every warp computes the same, so nothing is
// broadcast. Call after a cluster barrier that follows every CTA's
// build_coarse.
__device__ void cluster_select(const cg::cluster_group& cluster, int C,
                               unsigned* h, unsigned* coarse, int nb,
                               unsigned r, Select* sel, unsigned* digit,
                               unsigned* rest) {
  const int per = nb / kCoarse;
  if (C == 1) {  // this CTA's own histograms: no sums, no barriers
    unsigned cb, r1, f;
    warp_find(coarse, kCoarse, r, &cb, &r1);
    warp_find(h + cb * per, per, r1, &f, rest);
    *digit = cb * per + f;
    return;
  }
  const int m = threadIdx.x & 15, q = threadIdx.x >> 4;  // q < 16 loads
  const bool loads = threadIdx.x < kSelThreads;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  uint4 v = loads && m < C ? reinterpret_cast<const uint4*>(
                                 cluster.map_shared_rank(coarse, m))[q]
                           : zero;
  v = half_warp_sum(v);
  if (loads && m == 0) reinterpret_cast<uint4*>(sel->ctot)[q] = v;
  __syncthreads();
  unsigned cb, r1;
  warp_find(sel->ctot, kCoarse, r, &cb, &r1);
  v = (loads && m < C && 4 * q < per)
          ? reinterpret_cast<const uint4*>(cluster.map_shared_rank(h, m) +
                                           cb * per)[q]
          : zero;
  v = half_warp_sum(v);
  if (loads && m == 0 && 4 * q < per) {
    reinterpret_cast<uint4*>(sel->ftot)[q] = v;
  }
  __syncthreads();
  unsigned f, r2;
  warp_find(sel->ftot, per, r1, &f, &r2);
  *digit = cb * per + f;
  *rest = r2;
}

__device__ __forceinline__ void cluster_barrier(const cg::cluster_group& c,
                                                int C) {
  if (C == 1) {
    __syncthreads();
  } else {
    c.sync();
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Streams x[lo, hi) of a segment (x 16-byte aligned, lo a multiple of 4)
// through cp.async into shared memory, kPipe 16-byte copies in flight a
// thread: step s copies vector q = s kThreads + tid to dst(s, q), and once
// it has landed f(e, valid) runs on its four elements (valid: 0xF or 0);
// then the < 4 elements after the last vector, each in its own call with
// e[0] and valid 1 (or 0). Each thread reads back only its own copies, so
// no barrier is needed. A thread's elements come in index order; every
// thread makes the same calls.
template <class Dst, class F>
__device__ __forceinline__ void stream16(const unsigned* x, int lo, int hi,
                                         Dst&& dst, F&& f) {
  const int tid = threadIdx.x;
  const uint4* xv = reinterpret_cast<const uint4*>(x + lo);
  const int nv = (hi - lo) >> 2;
  const int steps = (nv + kThreads - 1) / kThreads;
  auto issue = [&](int s) {
    const int q = s * kThreads + tid;
    if (s < steps && q < nv) cp_async16(dst(s, q), xv + q);
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kPipe - 1; ++s) issue(s);
  for (int s = 0; s < steps; ++s) {
    issue(s + kPipe - 1);
    cp_async_wait<kPipe - 1>();
    const int q = s * kThreads + tid;
    const uint4 v = *dst(s, q);
    const unsigned e[4] = {v.x, v.y, v.z, v.w};
    f(e, q < nv ? 0xFu : 0u);
  }
  cp_async_wait<0>();
  const int tail = lo + 4 * nv;
  if (tail < hi) {  // the same in every thread
    const bool ok = tid < hi - tail;
    const unsigned e[4] = {ok ? __ldg(x + tail + tid) : 0u, 0u, 0u, 0u};
    f(e, ok ? 1u : 0u);
  }
}

// Reads x[lo, hi) of a segment a step at a time: each thread kStep elements
// e[0, kStep) with a bit a valid element, and calls f(e, valid, first) in
// every thread of every warp the same number of times. With vec (x 16-byte
// aligned, lo a multiple of 4) element i of a step is
// x[first + 4 (i / 4) kThreads + i % 4] (16-byte loads), and the last < 4
// elements come in one more step at position 0; else element i is
// x[first + i kThreads] (4-byte loads). A thread's elements come in index
// order.
template <class F>
__device__ __forceinline__ void for_each_step(const unsigned* x, int lo,
                                              int hi, bool vec, F&& f) {
  const int tid = threadIdx.x;
  unsigned e[kStep];
  if (vec) {
    const uint4* xv = reinterpret_cast<const uint4*>(x + lo);
    const int nv = (hi - lo) >> 2;
    for (int base = 0; base < nv; base += kUnroll * kThreads) {
      unsigned valid = 0;
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const int q = base + j * kThreads + tid;
        const uint4 v = q < nv ? __ldg(xv + q) : make_uint4(0u, 0u, 0u, 0u);
        e[4 * j] = v.x;
        e[4 * j + 1] = v.y;
        e[4 * j + 2] = v.z;
        e[4 * j + 3] = v.w;
        if (q < nv) valid |= 0xFu << (4 * j);
      }
      f(e, valid, lo + 4 * (base + tid));
    }
    const int tail = lo + 4 * nv;
    if (tail < hi) {  // the same in every thread
      const bool ok = tid < hi - tail;
#pragma unroll
      for (int i = 0; i < kStep; ++i) e[i] = 0u;
      e[0] = ok ? __ldg(x + tail + tid) : 0u;
      f(e, ok ? 1u : 0u, tail + tid);
    }
  } else {
    for (int base = lo; base < hi; base += kStep * kThreads) {
      unsigned valid = 0;
#pragma unroll
      for (int i = 0; i < kStep; ++i) {
        const int at = base + i * kThreads + tid;
        e[i] = at < hi ? __ldg(x + at) : 0u;
        if (at < hi) valid |= 1u << i;
      }
      f(e, valid, base + tid);
    }
  }
}

// The same over the held words data[0, cnt) (16-byte aligned): 16-byte
// loads, element 4j + t of a step from vector base + j kThreads + tid, the
// last < 4 elements in one more step at position 0. (Counts only: the
// order does not matter.)
template <class F>
__device__ __forceinline__ void for_each_step_held(const unsigned* data,
                                                   int cnt, F&& f) {
  const uint4* dv = reinterpret_cast<const uint4*>(data);
  const int nv = cnt >> 2;
  unsigned e[kStep];
  for (int base = 0; base < nv; base += kUnroll * kThreads) {
    unsigned valid = 0;
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int q = base + j * kThreads + threadIdx.x;
      const uint4 v = q < nv ? dv[q] : make_uint4(0u, 0u, 0u, 0u);
      e[4 * j] = v.x;
      e[4 * j + 1] = v.y;
      e[4 * j + 2] = v.z;
      e[4 * j + 3] = v.w;
      if (q < nv) valid |= 0xFu << (4 * j);
    }
    f(e, valid, 0);
  }
  if (4 * nv < cnt) {
    const bool ok = (int)threadIdx.x < cnt - 4 * nv;
#pragma unroll
    for (int i = 0; i < kStep; ++i) e[i] = 0u;
    e[0] = ok ? data[4 * nv + threadIdx.x] : 0u;
    f(e, ok ? 1u : 0u, 0);
  }
}

// A candidate list: slot c of thread t at mine[c kThreads + t] for the
// first `slots` a thread keeps (a count in a register: no atomics, no
// collective operations); the rest spill through one shared counter into
// spill[0, spill_cap). cnt counts past spill_cap.
struct List {
  unsigned* mine;
  unsigned slots;
  unsigned* spill;
  unsigned spill_cap;
  unsigned* cnt;
};

// A list over `words` words: three quarters as each thread's slots.
__device__ __forceinline__ List make_list(unsigned* base, unsigned words,
                                          unsigned* cnt) {
  const unsigned slots = words * 3 / 4 / kThreads;
  return List{base, slots, base + slots * kThreads,
              words - slots * kThreads, cnt};
}

// Where m holds, keeps b as this thread's c-th element of l and counts it:
// a predicated store, and a branch only for the spill.
__device__ __forceinline__ void keep_if(const List& l, unsigned& c,
                                        unsigned b, bool m) {
  if (m && c < l.slots) l.mine[c * kThreads + threadIdx.x] = b;
  if (m && c >= l.slots) {
    const unsigned s = atomicAdd(l.cnt, 1u);
    if (s < l.spill_cap) l.spill[s] = b;
  }
  c += m ? 1u : 0u;
}

// Keeps b, met in a part that all threads scan, straight in the spill.
__device__ __forceinline__ void keep_shared(const List& l, unsigned b) {
  const unsigned s = atomicAdd(l.cnt, 1u);
  if (s < l.spill_cap) l.spill[s] = b;
}

// Visits a list: this thread's own c elements, then the spill, strided;
// f(b, true) for each.
template <class F>
__device__ __forceinline__ void for_each_listed(const List& l, unsigned c,
                                                unsigned spilled, F&& f) {
  const unsigned mine = c < l.slots ? c : l.slots;
  for (unsigned i = 0; i < mine; ++i) {
    f(l.mine[i * kThreads + threadIdx.x], true);
  }
  const unsigned sp = spilled < l.spill_cap ? spilled : l.spill_cap;
  for (unsigned i = threadIdx.x; i < sp; i += kThreads) f(l.spill[i], true);
}

// The segment of CTA k of a cluster of C over a row of n elements: its start
// and length. Segments are multiples of 4 elements long, the last shorter.
__host__ __device__ __forceinline__ long long seg_len(long long n, int C) {
  return ((n + C - 1) / C + 3) / 4 * 4;
}
__device__ __forceinline__ void segment(long long n, int C, int k,
                                        long long* s0, int* len) {
  const long long seg = seg_len(n, C);
  const long long a = (long long)k * seg < n ? (long long)k * seg : n;
  const long long b = a + seg < n ? a + seg : n;
  *s0 = a;
  *len = (int)(b - a);
}

// Sum of v over the block, in every thread (unsigned: any order).
__device__ __forceinline__ unsigned block_sum(unsigned v, unsigned* s_u) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  if ((threadIdx.x & 31) == 0) s_u[threadIdx.x >> 5] = v;
  __syncthreads();
  unsigned t = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += s_u[w];
  __syncthreads();
  return t;
}

__global__ void __launch_bounds__(kThreads, 1)
order_stat_cluster_kernel(const unsigned* __restrict__ bits, long long n,
                          const int* __restrict__ ranks,
                          float* __restrict__ out) {
  extern __shared__ uint4 smem_raw[];
  unsigned* smem = reinterpret_cast<unsigned*>(smem_raw);
  __shared__ __align__(16) unsigned s_coarse[2][kCoarse];
  __shared__ Select s_sel;
  __shared__ double s_red_sum[kWarps];
  __shared__ float s_red_max[kWarps];
  __shared__ unsigned s_u[kWarps];
  __shared__ double s_part_sum;  // this CTA's sum and max
  __shared__ float s_part_max;
  __shared__ unsigned s_cnt, s_cnt2;  // the candidate lists' counters

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int k = (int)cluster.block_rank();
  const int row = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned* const h0 = smem;
  unsigned* const h1 = smem + kMaxBins;
  unsigned* const data = smem + 2 * kMaxBins;

  long long s0;
  int len;
  segment(n, C, k, &s0, &len);
  const bool resident = seg_len(n, C) <= kHoldWords;
  const int hold_cap = resident ? kHoldWords : kStreamHoldWords;
  const int held = len < hold_cap ? len : hold_cap;
  // After the held part: a longer row's window candidates (up to where its
  // staging ring starts), then digit 1's candidates: a resident row's in the
  // rest of the pool, a longer row's in the ring's place once the stream is
  // done.
  const List win = make_list(data + held,
                             resident ? 0u : kPoolWords - held - kRingWords,
                             &s_cnt);
  const List l2 = resident ? make_list(data + held, kPoolWords - held,
                                       &s_cnt2)
                           : make_list(data + kPoolWords - kRingWords,
                                       kRingWords, &s_cnt2);
  const unsigned* xrow = bits + (long long)row * n;
  const unsigned* x = xrow + s0;
  const bool vec = (reinterpret_cast<uintptr_t>(xrow) & 15) == 0;
  long long r64 = ranks[row];
  if (r64 < 0) r64 = 0;
  if (r64 > n - 1) r64 = n - 1;
  const unsigned rank = (unsigned)r64;

  for (int i = tid; i < kMaxBins / 4; i += kThreads) {
    reinterpret_cast<uint4*>(h0)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  if (tid == 0) {
    s_cnt = 0;
    s_cnt2 = 0;
  }
  __syncthreads();

  // Each thread's sum, in index order: each 4 elements of a step summed
  // pairwise in float32, (e0 + e1) + (e2 + e3), into a float64 sum; the max.
  double lsum = 0.0;
  float lmax = 0.f;
  auto add = [&](const auto& e, unsigned valid) {
    constexpr int E = sizeof(e) / sizeof(e[0]);
#pragma unroll
    for (int g = 0; g < E; g += 4) {
      float f[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        f[t] = (valid >> (g + t)) & 1u ? __uint_as_float(e[g + t]) : 0.f;
      }
      lsum += (double)((f[0] + f[1]) + (f[2] + f[3]));
      lmax = fmaxf(lmax, fmaxf(fmaxf(f[0], f[1]), fmaxf(f[2], f[3])));
    }
  };
  auto count0 = [&](const auto& e, unsigned valid) {
    constexpr int E = sizeof(e) / sizeof(e[0]);
#pragma unroll
    for (int i = 0; i < E; ++i) {
      if ((valid >> i) & 1u) atomicAdd(&h0[e[i] >> 20], 1u);
    }
    add(e, valid);
  };

  // Pass 0 over the held part: into shared memory, digit 0's histogram, the
  // sum and max. This and the pass below are the one read of the segment.
  if (vec) {
    uint4* const dv = reinterpret_cast<uint4*>(data);
    stream16(x, 0, held, [&](int, int q) { return dv + q; },
             [&](const unsigned(&e)[4], unsigned valid) {
               count0(e, valid);
             });
    const int tail = held & ~3;  // stream16 read these through registers
    if (tid < held - tail) data[tail + tid] = __ldg(x + tail + tid);
  } else {
    for_each_step(x, 0, held, vec, [&](const unsigned(&e)[kStep],
                                       unsigned valid, int first) {
#pragma unroll
      for (int i = 0; i < kStep; ++i) {
        if ((valid >> i) & 1u) data[first + i * kThreads] = e[i];
      }
      count0(e, valid);
    });
  }

  unsigned n_win = 0;  // this thread's window candidates
  unsigned* h = h0;  // the histogram of the current round, and its coarse
  unsigned* coarse = s_coarse[0];
  auto flip = [&]() {
    h = h == h0 ? h1 : h0;
    coarse = coarse == s_coarse[0] ? s_coarse[1] : s_coarse[0];
  };
  unsigned win_lo = 0, win_hi = kMaxBins - 1;
  if (!resident) {
    // The window: the digit-0 bins that hold ranks r·H/n +- (H/256 + 256)
    // of the cluster's held sample (H elements). The rest of the segment is
    // counted: bins below and above the window in registers, the window's
    // bins in h1, and its elements kept as candidates.
    for (int i = tid; i < kMaxBins / 4; i += kThreads) {
      reinterpret_cast<uint4*>(h1)[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    __syncthreads();
    build_coarse(h0, kMaxBins, s_coarse[0]);
    cluster_barrier(cluster, C);
    long long H = 0;
    for (int kk = 0; kk < C; ++kk) {
      long long a;
      int l;
      segment(n, C, kk, &a, &l);
      H += l < kStreamHoldWords ? l : kStreamHoldWords;
    }
    const long long est = (long long)rank * H / n;
    const long long delta = H / kWindowDiv + kWindowPad;
    const long long lo = est > delta ? est - delta : 0;
    const long long hi = est + delta < H - 1 ? est + delta : H - 1;
    unsigned rest;
    cluster_select(cluster, C, h0, s_coarse[0], kMaxBins, (unsigned)lo,
                   &s_sel, &win_lo, &rest);
    cluster_select(cluster, C, h0, s_coarse[0], kMaxBins, (unsigned)hi,
                   &s_sel, &win_hi, &rest);
    // The window in bit patterns: [lo_bits, lo_bits + span_bits): its bins
    // counted in h1, its elements kept in `win`.
    const unsigned lo_bits = win_lo << 20;
    const unsigned span_bits = (win_hi - win_lo + 1) << 20;
    unsigned below = 0;
    auto window = [&](const auto& e, unsigned valid) {
      constexpr int E = sizeof(e) / sizeof(e[0]);
#pragma unroll
      for (int i = 0; i < E; ++i) {
        const bool ok = (valid >> i) & 1u;
        below += ok && e[i] < lo_bits ? 1u : 0u;
        const bool in = ok && e[i] - lo_bits < span_bits;
        if (in) atomicAdd(&h1[e[i] >> 20], 1u);
        keep_if(win, n_win, e[i], in);
      }
      add(e, valid);
    };
    if (vec) {
      // The staging ring sits at the end of the pool, past the candidates.
      uint4* const ring = reinterpret_cast<uint4*>(data + kPoolWords -
                                                   kRingWords);
      stream16(x, held, len,
               [&](int st, int) {
                 return ring + (st % kPipe) * kThreads + tid;
               },
               window);
    } else {
      for_each_step(x, held, len, vec,
                    [&](const unsigned(&e)[kStep], unsigned valid, int) {
                      window(e, valid);
                    });
    }
    below = block_sum(below, s_u);
    const unsigned in_window = block_sum(n_win, s_u);
    // The streamed elements above the window: the rest of those not below
    // it and not in it.
    const unsigned above = (unsigned)(len - held) - below - in_window;
    // h1: the held counts, the window's streamed counts, the streamed mass
    // below the window in the bin before it and above in the bin after it.
    for (int i = tid; i < kMaxBins; i += kThreads) h1[i] += h0[i];
    __syncthreads();
    if (tid == 0) {
      if (win_lo > 0) h1[win_lo - 1] += below;
      if (win_hi < kMaxBins - 1) h1[win_hi + 1] += above;
    }
    flip();
  }

  // This CTA's sum and max, in a fixed order: a butterfly in each warp,
  // then one over the warps, in float64.
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lsum += __shfl_xor_sync(kFull, lsum, off);
    lmax = fmaxf(lmax, __shfl_xor_sync(kFull, lmax, off));
  }
  if (lane == 0) {
    s_red_sum[warp] = lsum;
    s_red_max[warp] = lmax;
  }
  __syncthreads();
  if (warp == 0) {
    double ts = lane < kWarps ? s_red_sum[lane] : 0.0;
    float tm = lane < kWarps ? s_red_max[lane] : 0.f;
#pragma unroll
    for (int off = kWarps / 2; off > 0; off >>= 1) {
      ts += __shfl_xor_sync(kFull, ts, off);
      tm = fmaxf(tm, __shfl_xor_sync(kFull, tm, off));
    }
    if (lane == 0) {
      s_part_sum = ts;
      s_part_max = tm;
    }
  }
  // A longer row's CTA counts digits 1 and 2 over its held part and its
  // window candidates if they all fit and the chosen bin is in the window;
  // else over its segment, re-read.
  const unsigned win_spilled = s_cnt;
  bool from_global = !resident && win_spilled > win.spill_cap;

  unsigned r = rank, prefix = 0, fixed = 0;
  unsigned n_l2 = 0;  // this thread's digit-1 candidates
  double row_sum = 0.0;
  float row_max = 0.f;
  for (int d = 0; d < 3; ++d) {
    const int nb = d == 0 ? kMaxBins : 1 << kRestBits;
    const int shift = d == 0 ? 32 - kFirstBits : kRestBits * (2 - d);
    build_coarse(h, nb, coarse);
    cluster_barrier(cluster, C);  // every CTA's histogram of this round
    if (d == 0 && k == 0 && tid == 0) {
      for (int m = 0; m < C; ++m) {
        row_sum += *cluster.map_shared_rank(&s_part_sum, m);
        row_max = fmaxf(row_max, *cluster.map_shared_rank(&s_part_max, m));
      }
    }
    unsigned digit;
    cluster_select(cluster, C, h, coarse, nb, r, &s_sel, &digit, &r);
    if (d == 0 && !resident && (digit < win_lo || digit > win_hi)) {
      // The window missed (the same in every CTA): count digit 0 again over
      // the whole segment, re-read, and select again.
      from_global = true;
      flip();
      for (int i = tid; i < kMaxBins; i += kThreads) h[i] = 0;
      __syncthreads();
      for_each_step(x, 0, len, vec, [&](const unsigned(&e)[kStep],
                                        unsigned valid, int) {
#pragma unroll
        for (int i = 0; i < kStep; ++i) {
          if ((valid >> i) & 1u) atomicAdd(&h[e[i] >> 20], 1u);
        }
      });
      __syncthreads();
      build_coarse(h, nb, coarse);
      cluster_barrier(cluster, C);
      cluster_select(cluster, C, h, coarse, nb, rank, &s_sel, &digit, &r);
    }
    prefix |= digit << shift;
    fixed |= (unsigned)(nb - 1) << shift;
    if (d == 2) break;

    // The next digit's histogram, in the other buffer (the CTAs that read
    // it in the round before this one have all passed this round's barrier).
    flip();
    for (int i = tid; i < (1 << kRestBits); i += kThreads) h[i] = 0;
    __syncthreads();
    const int nshift = shift - kRestBits;
    const unsigned nmask = (1u << kRestBits) - 1u;
    // Counts the elements of the chosen prefix; digit 1's pass also keeps
    // them in l2 (this thread's own, or the spill for the elements of a
    // part that all threads scan).
    const bool keep = d == 0 && !from_global;
    auto count1 = [&](unsigned b, bool ok) {
      if (ok && (b & fixed) == prefix) {
        atomicAdd(&h[(b >> nshift) & nmask], 1u);
      }
    };
    auto own = [&](unsigned b, bool ok) {
      if (ok && (b & fixed) == prefix) {
        atomicAdd(&h[(b >> nshift) & nmask], 1u);
        if (keep) keep_if(l2, n_l2, b, true);
      }
    };
    auto shared = [&](unsigned b, bool ok) {
      if (ok && (b & fixed) == prefix) {
        atomicAdd(&h[(b >> nshift) & nmask], 1u);
        if (keep) keep_shared(l2, b);
      }
    };
    auto steps = [&](auto&& f) {
      return [&](const unsigned(&e)[kStep], unsigned valid, int) {
#pragma unroll
        for (int i = 0; i < kStep; ++i) {
          if ((valid >> i) & 1u) f(e[i], true);
        }
      };
    };
    const unsigned l2_spilled = s_cnt2;
    if (from_global) {
      for_each_step(x, 0, len, vec, steps(count1));
    } else if (d == 1 && l2_spilled <= l2.spill_cap) {
      for_each_listed(l2, n_l2, l2_spilled, count1);
    } else {
      for_each_step_held(data, held, steps(own));
      if (!resident) {  // the window's: this thread's own, then the spill
        const unsigned mine = n_win < win.slots ? n_win : win.slots;
        for (unsigned i = 0; i < mine; ++i) {
          own(win.mine[i * kThreads + tid], true);
        }
        for (unsigned i = tid; i < win_spilled; i += kThreads) {
          shared(win.spill[i], true);
        }
      }
    }
    __syncthreads();
  }

  if (k == 0 && tid == 0) {
    out[3LL * row + 0] = __uint_as_float(prefix);
    out[3LL * row + 1] = row_max;
    out[3LL * row + 2] = (float)row_sum;
  }
  // No CTA leaves while another may still read its shared memory.
  if (C > 1) cluster.sync();
}

constexpr size_t kSmemBytes = (2 * kMaxBins + kPoolWords) * sizeof(unsigned);

std::mutex g_mutex;
// Per device: the clusters of 1, 2, 4, 8 and 16 full-size CTAs the card
// holds at once (from the occupancy API), and whether they are known.
int g_active[64][5];
bool g_known[64];

cudaError_t active_clusters(int device, const int** out) {
  std::lock_guard<std::mutex> lock(g_mutex);
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (!g_known[device]) {
    cudaError_t err = cudaFuncSetAttribute(
        order_stat_cluster_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(order_stat_cluster_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (err != cudaSuccess) return err;
    for (int e = 0; e < 5; ++e) {
      cudaLaunchConfig_t cfg = {};
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = 1 << e;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cfg.gridDim = dim3(1 << e, 1, 1);
      cfg.blockDim = dim3(kThreads, 1, 1);
      cfg.dynamicSmemBytes = kSmemBytes;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      err = cudaOccupancyMaxActiveClusters(&g_active[device][e],
                                           order_stat_cluster_kernel, &cfg);
      if (err != cudaSuccess) return err;
    }
    if (g_active[device][3] < 1) return cudaErrorLaunchOutOfResources;
    g_known[device] = true;
  }
  *out = g_active[device];
  return cudaSuccess;
}

}  // namespace

// The cluster size a call over `rows` rows of n elements takes on `device`,
// and whether its rows are resident (held whole in the cluster's shared
// memory). The fewest CTAs that hold a row, if all rows then run at once;
// else 16 or 8 CTAs a row (held in part, the rest through the window),
// whichever needs fewer waves of clusters, resident first, then the larger.
// Returns the cudaError_t of the device query.
extern "C" int atq_order_stat_plan(int device, long long n, int rows,
                                   int* cluster, int* resident) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int* active = nullptr;
  err = active_clusters(device, &active);
  if (err != cudaSuccess) return (int)err;
  const int cmax = active[4] > 0 ? 16 : 8;
  int best = 0;
  bool best_res = false;
  long long best_waves = 0;
  for (int e = 0; (1 << e) <= cmax; ++e) {
    const int c = 1 << e;
    const bool res = seg_len(n, c) <= kHoldWords;
    if (!res && c < cmax / 2) continue;
    const long long waves = (rows + active[e] - 1) / active[e];
    if (best == 0 || waves < best_waves ||
        (waves == best_waves && (res || !best_res))) {
      best = c;
      best_res = res;
      best_waves = waves;
    }
    if (res) break;  // a larger resident cluster is never fewer waves
  }
  *cluster = best;
  *resident = seg_len(n, best) <= kHoldWords ? 1 : 0;
  return cudaSuccess;
}

// x: rows x n non-negative floats on the device (row-major); rank: one int32
// per row on the device; out: rows x 3 floats [stat, max, sum]. One cluster
// launch on `stream`, with no synchronisation and no scratch. Returns the
// cudaError_t of the launch.
extern "C" int atq_order_stat(int device, const float* x, long long n,
                              int rows, const int* rank, float* out,
                              void* stream) {
  int c = 0, resident = 0;
  const int err_plan = atq_order_stat_plan(device, n, rows, &c, &resident);
  if (err_plan != 0) return err_plan;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(c, rows, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, order_stat_cluster_kernel, reinterpret_cast<const unsigned*>(x),
      n, rank, out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
