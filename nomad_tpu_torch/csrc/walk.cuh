// Shared device code: the per-node score (`score_node`), which every
// kernel that scores a node uses (K1, K2, K3, K5, K7, K9, K10, K11, K12,
// K14), the walk's constants and winner key, the block scans that K3's
// and K12's walks use, and the shuffled limited walk of one block
// (`limited_walk`), which K5 (storm_solve.cu) and K14 (storm_sharded.cu)
// run for their warm start.  K1, K2, K6, K7, K9 and K10 walk as prefix
// walks (picks.cuh), K1's and K6's whole-region selects on a grid
// (walk_grid.cuh).
//
// Replaces the arithmetic that the JAX programs share:
//   nomad_tpu/ops/score.py  _pow10 (:69), _score_vectors (:110) with
//                           its policy branch (:163-180),
//                           _limited_walk_argmax (:186)
//   nomad_tpu/ops/batch.py  _walk (:281), _rotated_prefix (:268)
//
// `limited_walk`: one block of kThreads threads walks n_walk positions;
// thread t owns the contiguous run [t*run, (t+1)*run), so block-exclusive
// scans of per-thread counts give every position its rank in walk order.
// The walk is three passes over the run:
//   A  score each position, flag feasible and "bad" (score <= 0), store
//      both in scratch (each thread re-reads only its own positions);
//   B  rank the bad positions; the first kMaxSkip are diverted;
//   C  emit order (non-diverted first, diverted after, two diverted
//      replayed reversed when a good node was emitted), the winner as
//      the strict maximum with ties to the earliest emission, and the
//      walk position of the limit-th non-diverted node for `pulls`.
//
// Exactness: every float op is written out in the JAX program's order,
// each rounded on its own (build with -fmad=false, never fast math);
// 10^x is pow in double rounded through float, as the JAX package
// defines it; counts stay int32 and cannot overflow (at most n_walk + 2).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace nk {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSkip = 3;  // reference stack.go:17
constexpr int kNoNode = -1;
constexpr int kInt32Max = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

// per-position walk flags
constexpr uint8_t kFeasible = 1;
constexpr uint8_t kBad = 2;
constexpr uint8_t kDiverted = 4;

// Canonical 10^x: f64 pow rounded through float32, then widened.
template <typename T>
__device__ __forceinline__ T pow10_f32(T x) {
  const double raw = pow(10.0, static_cast<double>(x));
  return static_cast<T>(__double2float_rn(raw));
}

// Correctly rounded a * b + c (never contracted or split by the compiler).
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}

// The policy-weighted terms of one node (ops/score.py PolicyTerms),
// pre-scaled on the host.  A group whose flag is off is absent.
template <typename T>
struct PolicyNode {
  bool tput_on = false;
  T tput = T(0);      // coef * normalized throughput of the node
  T has_tput = T(0);  // the count the throughput term adds
  bool mig_on = false;
  T mig = T(0);       // coef * (-1 off the incumbent nodes, 0 on them)
};

// The per-node score: BestFit-v3 binpack (or worst-fit under
// spread_fit), job anti-affinity, reschedule penalty, node affinity,
// (when kDevAff) the device-affinity match fraction of an ask whose
// affinities carry weight (`dev_on`; appended even when 0), (when
// kSpread) the spread boost, and (when kPolicy) the policy terms, as a
// (sum, count) mean.  The additions of zero that the JAX program makes
// for absent terms are kept, so the operation sequence is the same.
// The policy terms are added unconditionally, as the JAX program adds
// them (a -0.0 term stays an exact no-op); only their counts are
// predicated.  Call sites without kPolicy compile to the same code.
template <typename T, bool kSpread, bool kDevAff = false,
          bool kPolicy = false>
__device__ __forceinline__ T score_node(T cpu_total, T mem_total,
                                        T cpu_after, T mem_after,
                                        int coll, bool penalty, T aff,
                                        T spread, T desired,
                                        bool spread_fit,
                                        T dev_aff = T(0),
                                        bool dev_on = false,
                                        PolicyNode<T> pol = {}) {
  const T one = T(1);
  const T zero = T(0);
  const T safe_cpu = cpu_total > zero ? cpu_total : one;
  const T safe_mem = mem_total > zero ? mem_total : one;
  const T free_cpu = one - cpu_after / safe_cpu;
  const T free_mem = one - mem_after / safe_mem;
  const T base = pow10_f32<T>(free_cpu) + pow10_f32<T>(free_mem);
  T fitness = spread_fit ? base - T(2) : T(20) - base;
  fitness = fitness < zero ? zero : (fitness > T(18) ? T(18) : fitness);
  T count = one;

  const bool has_coll = coll > 0;
  const T anti = has_coll ? -(static_cast<T>(coll) + one) / desired : zero;
  // binpack (fitness / 18) plus anti-affinity as the compiled JAX
  // program computes it: XLA turns the division by a constant into a
  // multiply by RN(1/18) and contracts it with the add into one fma.
  // An explicit fma is kept under -fmad=false.
  T score_sum = fma_rn(fitness, static_cast<T>(1.0 / 18.0), anti);
  count = count + (has_coll ? one : zero);

  const T pen = penalty ? one : zero;
  score_sum = score_sum - pen;
  count = count + pen;

  const bool has_aff = aff != zero;
  score_sum = score_sum + (has_aff ? aff : zero);
  count = count + (has_aff ? one : zero);

  if (kDevAff) {
    score_sum = score_sum + (dev_on ? dev_aff : zero);
    count = count + (dev_on ? one : zero);
  }
  if (kSpread) {
    const bool has_spread = spread != zero;
    score_sum = score_sum + (has_spread ? spread : zero);
    count = count + (has_spread ? one : zero);
  }
  if (kPolicy) {
    if (pol.tput_on) {
      score_sum = score_sum + pol.tput;
      count = count + pol.has_tput;
    }
    if (pol.mig_on) {
      score_sum = score_sum + pol.mig;
      count = count + (pol.mig != zero ? one : zero);
    }
  }
  return score_sum / count;
}

// Block-wide exclusive scan of N ints per thread.  On return v[n] holds
// the sum over all lower threads and total[n] the block sum.  Needs
// blockDim.x == kThreads and smem of N * kWarps + N ints.
template <int N>
__device__ __forceinline__ void block_exclusive_scan(int (&v)[N],
                                                     int (&total)[N],
                                                     int* smem) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl[N];
#pragma unroll
  for (int n = 0; n < N; ++n) incl[n] = v[n];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int y = __shfl_up_sync(kFull, incl[n], d);
      if (lane >= d) incl[n] += y;
    }
  }
  if (lane == 31) {
#pragma unroll
    for (int n = 0; n < N; ++n) smem[n * kWarps + warp] = incl[n];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int x = smem[n * kWarps + lane];
      int xi = x;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kFull, xi, d);
        if (lane >= d) xi += y;
      }
      smem[n * kWarps + lane] = xi - x;
      if (lane == 31) smem[N * kWarps + n] = xi;
    }
  }
  __syncthreads();
#pragma unroll
  for (int n = 0; n < N; ++n) {
    v[n] = smem[n * kWarps + warp] + incl[n] - v[n];
    total[n] = smem[N * kWarps + n];
  }
  __syncthreads();  // smem is reused by the next scan
}

template <typename T>
struct WalkOut {
  T best;              // max emitted score (-inf when none)
  int win_w;           // walk position of the winner (-1 when none)
  int any;             // 1 when at least one node was emitted
  int pulls;           // source positions consumed by this select
  int feasible_count;  // feasible positions in the walk
};

// The winner key: higher score first, then earlier emission.
template <typename T>
__device__ __forceinline__ bool better(T s, int ord, T bs, int bord) {
  return s > bs || (s == bs && ord < bord);
}

// A walk's best (score, emit order) key with its position, and the
// least walk position of the limit-th non-diverted node.
template <typename T>
struct Best {
  T s;
  int ord;
  int w;
  int lth;
};

// The best key and the least limit-th position over the block's
// threads: a warp tree, then warp 0 over the warps' results.  Every
// thread of the block must call it; every thread gets the result.
template <typename T>
__device__ Best<T> block_best(Best<T> v) {
  __shared__ T red_s[kWarps];
  __shared__ int red_ord[kWarps];
  __shared__ int red_w[kWarps];
  __shared__ int red_lth[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const T os = __shfl_down_sync(kFull, v.s, d);
    const int oo = __shfl_down_sync(kFull, v.ord, d);
    const int ow = __shfl_down_sync(kFull, v.w, d);
    const int ol = __shfl_down_sync(kFull, v.lth, d);
    if (better(os, oo, v.s, v.ord)) {
      v.s = os;
      v.ord = oo;
      v.w = ow;
    }
    v.lth = min(v.lth, ol);
  }
  if (lane == 0) {
    red_s[warp] = v.s;
    red_ord[warp] = v.ord;
    red_w[warp] = v.w;
    red_lth[warp] = v.lth;
  }
  __syncthreads();
  if (warp == 0) {
    v.s = red_s[lane];
    v.ord = red_ord[lane];
    v.w = red_w[lane];
    v.lth = red_lth[lane];
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      const T os = __shfl_down_sync(kFull, v.s, d);
      const int oo = __shfl_down_sync(kFull, v.ord, d);
      const int ow = __shfl_down_sync(kFull, v.w, d);
      const int ol = __shfl_down_sync(kFull, v.lth, d);
      if (better(os, oo, v.s, v.ord)) {
        v.s = os;
        v.ord = oo;
        v.w = ow;
      }
      v.lth = min(v.lth, ol);
    }
    if (lane == 0) {
      red_s[0] = v.s;
      red_ord[0] = v.ord;
      red_w[0] = v.w;
      red_lth[0] = v.lth;
    }
  }
  __syncthreads();
  Best<T> out;
  out.s = red_s[0];
  out.ord = red_ord[0];
  out.w = red_w[0];
  out.lth = red_lth[0];
  __syncthreads();  // red_* is reused by the next call
  return out;
}

// Runs the limited walk over walk positions [0, n_walk).  score_at(w,
// s, f) gives position w's score and feasibility.  `n_pulls_dry` is the
// pull count when fewer than `limit` good nodes exist (the whole
// candidate list is consumed).  s_w/f_w are n_walk-long scratch.  Every
// thread of the block must call it; every thread gets the result.
template <typename T, typename ScoreAt>
__device__ WalkOut<T> limited_walk(int n_walk, int limit, int n_pulls_dry,
                                   T* __restrict__ s_w,
                                   uint8_t* __restrict__ f_w,
                                   ScoreAt score_at) {
  __shared__ int scan_smem[2 * kWarps + 2];

  const int tid = threadIdx.x;
  const int run = (n_walk + kThreads - 1) / kThreads;
  const int lo = min(tid * run, n_walk);
  const int hi = min(lo + run, n_walk);

  // pass A: score, feasibility, bad flags
  int a[2] = {0, 0};  // bad, feasible
  for (int w = lo; w < hi; ++w) {
    T s;
    bool f;
    score_at(w, s, f);
    uint8_t fl = f ? kFeasible : 0;
    if (f && s <= T(0)) fl |= kBad;
    s_w[w] = s;
    f_w[w] = fl;
    a[0] += (fl & kBad) ? 1 : 0;
    a[1] += f ? 1 : 0;
  }
  int a_tot[2];
  block_exclusive_scan<2>(a, a_tot, scan_smem);
  const int feasible_count = a_tot[1];

  // pass B: the first kMaxSkip bad positions are diverted
  int bad_rank = a[0];
  int b[2] = {0, 0};  // non-diverted feasible, diverted
  for (int w = lo; w < hi; ++w) {
    uint8_t fl = f_w[w];
    if (fl & kBad) {
      ++bad_rank;
      if (bad_rank <= kMaxSkip) {
        fl |= kDiverted;
        f_w[w] = fl;
      }
    }
    const bool div = (fl & kDiverted) != 0;
    b[0] += ((fl & kFeasible) && !div) ? 1 : 0;
    b[1] += div ? 1 : 0;
  }
  int b_tot[2];
  block_exclusive_scan<2>(b, b_tot, scan_smem);
  const int nd_count = b_tot[0];
  const int n_div = b_tot[1];
  const bool reverse = (n_div == 2) && (nd_count > 0);

  // pass C: emit order, winner, limit-th good node
  int nd_incl = b[0];
  int div_incl = b[1];
  T best_s = -INFINITY;
  int best_ord = kInt32Max;
  int best_w = -1;
  int lth = kInt32Max;
  for (int w = lo; w < hi; ++w) {
    const uint8_t fl = f_w[w];
    if (!(fl & kFeasible)) continue;
    int ord;
    if (fl & kDiverted) {
      ++div_incl;
      const int div_rank = div_incl - 1;
      ord = nd_count + (reverse ? 1 - div_rank : div_rank);
    } else {
      ++nd_incl;
      ord = nd_incl - 1;
      if (nd_incl == limit) lth = w;
    }
    if (ord < limit) {
      const T s = s_w[w];
      if (better(s, ord, best_s, best_ord)) {
        best_s = s;
        best_ord = ord;
        best_w = w;
      }
    }
  }

  // block reduction: winner key and min limit-th position
  Best<T> v;
  v.s = best_s;
  v.ord = best_ord;
  v.w = best_w;
  v.lth = lth;
  v = block_best<T>(v);
  WalkOut<T> out;
  out.best = v.s;
  out.any = v.ord != kInt32Max ? 1 : 0;
  out.win_w = v.w;
  out.pulls = nd_count >= limit ? v.lth + 1 : n_pulls_dry;
  out.feasible_count = feasible_count;
  return out;
}

}  // namespace nk
