// The whole-region walk on a cooperative grid, shared by kernels K1
// (score_select.cu) and K6 (walk_only.cu): the shape their rule
// (`takes_grid`) gives a select whose limit reaches the candidates, so
// that the walk consumes the region.
//
// Replaces, for such a select, the walk of nomad_tpu/ops/score.py:186
// _limited_walk_argmax over all C walk positions without a rotation (the
// caller rotates perm), as K1's and K6's prefix walk (picks.cuh) does for
// the others.
//
// One cooperative launch of blocks of kGridThreads, block b taking the
// walk positions [b * span, (b + 1) * span), a thread a contiguous run.
// A source gives a walk position's feasibility and score: K1's scores
// the position (test then score) and writes its flags and score into the
// walk scratch, from which it rereads them; K6's reads the given vectors
// through perm in every pass and needs no scratch.  Each block writes a
// summary: its feasible and bad counts, its first kMaxSkip bad positions
// (score, position), and its best (score, position) over its other
// feasible positions, the earlier position first on a tie.  After one
// grid barrier the first warp of block 0 combines the summaries in block
// order.  Prefix counts over the blocks give every block the feasible
// and bad positions before it, hence which of its first bad positions
// are among the walk's first kMaxSkip (diverted) and which compete as
// non-diverted, the non-diverted count, and the block that holds the
// limit-th non-diverted position if there is one; the warp rescans that
// block's positions through the source (flags, and a score only where it
// competes) for their emit orders below the limit and the limit-th
// position, and takes no later block.  The diverted positions compete
// last, with their orders from the totals, two of them reversed behind a
// good node.
//
// Exactness: a non-diverted position's emit order is its rank among
// them, so it grows with the walk position: the best (score, position)
// with the earlier position on a tie is the best (score, order) over
// non-diverted positions, across blocks as within one.  A diverted
// position's order is at least the non-diverted count, above every
// non-diverted order.  Scores are compared as the source gives them.
//
// A source `src` has, for walk position w:
//   bool score(w, s)          pass 1: feasibility, and the score in `s`
//                             where feasible;
//   uint8_t flags(w, other)   kFeasible | kBad as pass 1 found them;
//   T score_at(w, other)      the score of a feasible position;
// `other` is set where another block may have written what the source
// rereads (the combine), so such a read bypasses L1.
#pragma once

#include <cooperative_groups.h>

#include "walk.cuh"

namespace nk {

constexpr int kGridThreads = 128;
constexpr int kGridWarps = kGridThreads / 32;
constexpr int kSumInts = 8;  // feasible, bad, best_w, bad_w[3], 2 spare
constexpr int kSumVals = 4;  // best_s, bad_s[3]
constexpr int kNone = kInt32Max;  // no position

// The rule of K1 and K6: the grid iff the limit reaches the candidates.
// A limit below them lets the walk stop early, and a short walk (limit
// 14, ~20 of 10,000 positions) is one or two steps of the prefix walk;
// a limit of n_candidates or more is a whole-region walk, which the grid
// spreads over the card.  A limited walk that runs long would be faster
// on the grid too, but only the walk itself can tell how long it runs.
__host__ __device__ inline bool takes_grid(int limit, int n_candidates) {
  return limit >= n_candidates;
}

// Bytes of the per-block summaries of a C-position walk.
__host__ __device__ inline size_t summary_bytes(int C, size_t t_size) {
  const size_t blocks = (static_cast<size_t>(C) + kGridThreads - 1) /
                        kGridThreads;
  return blocks * (kSumInts * sizeof(int32_t) + kSumVals * t_size);
}

// The summaries: [blocks, kSumInts] ints, then [blocks, kSumVals] T.
template <typename T>
struct GridSums {
  int32_t* i;
  T* v;
};

template <typename T>
__host__ __device__ inline GridSums<T> bind_sums(void* base, int C) {
  const size_t blocks =
      (static_cast<size_t>(C) + kGridThreads - 1) / kGridThreads;
  GridSums<T> g;
  g.i = static_cast<int32_t*>(base);
  g.v = g.i != nullptr ? reinterpret_cast<T*>(g.i + blocks * kSumInts)
                       : nullptr;
  return g;
}

// What the combine gives: the winner's walk position (-1 for none), its
// score, the feasible positions, and the pulls.
template <typename T>
struct GridEnd {
  int win_w;
  T best;
  int feasible;
  int pulls;
};

// The best key over positions: higher score, then the earlier position.
template <typename T>
__device__ __forceinline__ bool better_sw(T s, int w, T bs, int bw) {
  return s > bs || (s == bs && w < bw);
}

// The combine: the first warp of block 0, after the grid barrier.  Lane
// 0 gets the result.
template <typename T, typename Src>
__device__ GridEnd<T> grid_combine(const Src& src, const GridSums<T>& g,
                                   int nb, int span, int C, int limit,
                                   int n_dry) {
  __shared__ T div_s[kMaxSkip];
  __shared__ int div_w[kMaxSkip];
  __shared__ int held[3];  // the block with the limit-th position, and
                           // the feasible and bad positions before it
  const int lane = threadIdx.x;
  const unsigned below = (1u << lane) - 1u;
  const int m = (nb + 31) / 32;
  const int b0 = min(lane * m, nb);
  const int b1 = min(b0 + m, nb);
  int lf = 0;
  int lb = 0;
  for (int b = b0; b < b1; ++b) {
    lf += __ldcg(g.i + b * kSumInts);
    lb += __ldcg(g.i + b * kSumInts + 1);
  }
  int inc_f = lf;
  int inc_b = lb;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int yf = __shfl_up_sync(kFull, inc_f, d);
    const int yb = __shfl_up_sync(kFull, inc_b, d);
    if (lane >= d) {
      inc_f += yf;
      inc_b += yb;
    }
  }
  const int f_tot = __shfl_sync(kFull, inc_f, 31);
  const int b_tot = __shfl_sync(kFull, inc_b, 31);
  const int nd_count = f_tot - min(b_tot, kMaxSkip);
  const bool stop = nd_count >= limit;
  T bs = -INFINITY;
  int bw = kNone;
  int fb = inc_f - lf;  // feasible positions before block b
  int bb = inc_b - lb;  // bad positions before block b
  for (int b = b0; b < b1; ++b) {
    const int32_t* si = g.i + b * kSumInts;
    const T* sv = g.v + b * kSumVals;
    const int fa = fb + __ldcg(si);
    const int ba = bb + __ldcg(si + 1);
    const int nd_before = fb - min(bb, kMaxSkip);
    const int nd_after = fa - min(ba, kMaxSkip);
    // every non-diverted position of the block is emitted
    const bool all_in = !stop || nd_after < limit;
    for (int j = 0; j < min(ba - bb, kMaxSkip); ++j) {
      const T s = __ldcg(sv + 1 + j);
      const int w = __ldcg(si + 3 + j);
      if (bb + j < kMaxSkip) {
        div_s[bb + j] = s;
        div_w[bb + j] = w;
      } else if (all_in && better_sw(s, w, bs, bw)) {
        bs = s;
        bw = w;
      }
    }
    if (all_in) {
      const int w = __ldcg(si + 2);
      const T s = __ldcg(sv);
      if (w != kNone && better_sw(s, w, bs, bw)) {
        bs = s;
        bw = w;
      }
    } else if (nd_before < limit) {
      held[0] = b;
      held[1] = fb;
      held[2] = bb;
    }
    fb = fa;
    bb = ba;
  }
  __syncwarp();
  int lth = -1;
  if (stop) {
    // the block holding the limit-th non-diverted position, rescanned
    // in walk order through the source
    const int lo = held[0] * span;
    const int hi = min(lo + span, C);
    int run_f = held[1];
    int run_b = held[2];
    for (int base = lo; base < hi; base += 32) {
      const int w = base + lane;
      const uint8_t fl = w < hi ? src.flags(w, true) : 0;
      const bool f = (fl & kFeasible) != 0;
      const bool bad = (fl & kBad) != 0;
      const unsigned fm = __ballot_sync(kFull, f);
      const unsigned bm = __ballot_sync(kFull, bad);
      const int fbf = run_f + __popc(fm & below);
      const int bbf = run_b + __popc(bm & below);
      if (f && !(bad && bbf < kMaxSkip)) {
        const int ord = fbf - min(bbf, kMaxSkip);
        if (ord < limit) {
          const T s = src.score_at(w, true);
          if (better_sw(s, w, bs, bw)) {
            bs = s;
            bw = w;
          }
        }
        if (ord + 1 == limit) lth = w;
      }
      run_f += __popc(fm);
      run_b += __popc(bm);
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const T os = __shfl_down_sync(kFull, bs, d);
    const int ow = __shfl_down_sync(kFull, bw, d);
    lth = max(lth, __shfl_down_sync(kFull, lth, d));
    if (better_sw(os, ow, bs, bw)) {
      bs = os;
      bw = ow;
    }
  }
  GridEnd<T> out;
  // a non-diverted order is below every diverted one
  int best_ord = bw != kNone ? -1 : kInt32Max;
  int win = bw != kNone ? bw : -1;
  if (lane == 0 && !stop) {
    const int n_div = min(b_tot, kMaxSkip);
    const bool reverse = (n_div == 2) && (nd_count > 0);
    for (int r = 0; r < n_div; ++r) {
      const int ord = nd_count + (reverse ? 1 - r : r);
      if (ord < limit && better(div_s[r], ord, bs, best_ord)) {
        bs = div_s[r];
        best_ord = ord;
        win = div_w[r];
      }
    }
  }
  out.win_w = win;
  out.best = bs;
  out.feasible = f_tot;
  out.pulls = stop ? lth + 1 : n_dry;
  return out;
}

// The grid's walk over walk positions [0, C): every thread of every
// block of the cooperative launch calls it.  Returns true on the one
// thread that holds the result in `out` (block 0, thread 0).
template <typename T, typename Src>
__device__ bool grid_walk(const Src& src, const GridSums<T>& g, int C,
                          int limit, int n_dry, GridEnd<T>& out) {
  __shared__ int scan[2][kGridWarps];
  __shared__ T bad_s[kMaxSkip];
  __shared__ int bad_w[kMaxSkip];
  __shared__ T red_s[kGridWarps];
  __shared__ int red_w[kGridWarps];
  const int nb = gridDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int span = (C + nb - 1) / nb;
  const int run = (span + kGridThreads - 1) / kGridThreads;
  const int lo = min(static_cast<int>(blockIdx.x) * span, C);
  const int hi = min(lo + span, C);
  const int t_lo = min(lo + tid * run, hi);
  const int t_hi = min(t_lo + run, hi);
  // pass 1: the thread's run through the source
  int nf = 0;
  int nbad = 0;
  for (int w = t_lo; w < t_hi; ++w) {
    T s = T(0);
    const bool f = src.score(w, s);
    nf += f;
    nbad += f && s <= T(0);
  }
  // the block's exclusive prefix of (feasible, bad) over its threads
  int inc_f = nf;
  int inc_b = nbad;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int yf = __shfl_up_sync(kFull, inc_f, d);
    const int yb = __shfl_up_sync(kFull, inc_b, d);
    if (lane >= d) {
      inc_f += yf;
      inc_b += yb;
    }
  }
  if (lane == 31) {
    scan[0][warp] = inc_f;
    scan[1][warp] = inc_b;
  }
  __syncthreads();
  int blk_f = 0;
  int blk_b = 0;
  int rank = inc_b - nbad;  // bad positions before the thread's run
  for (int i = 0; i < kGridWarps; ++i) {
    if (i < warp) rank += scan[1][i];
    blk_f += scan[0][i];
    blk_b += scan[1][i];
  }
  // pass 2: the block's first kMaxSkip bad positions aside; the best of
  // the rest
  T bs = -INFINITY;
  int bw = kNone;
  for (int w = t_lo; w < t_hi; ++w) {
    const uint8_t fl = src.flags(w, false);
    if (!(fl & kFeasible)) continue;
    const T s = src.score_at(w, false);
    if (fl & kBad) {
      ++rank;
      if (rank <= kMaxSkip) {
        bad_s[rank - 1] = s;
        bad_w[rank - 1] = w;
        continue;
      }
    }
    if (better_sw(s, w, bs, bw)) {
      bs = s;
      bw = w;
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const T os = __shfl_down_sync(kFull, bs, d);
    const int ow = __shfl_down_sync(kFull, bw, d);
    if (better_sw(os, ow, bs, bw)) {
      bs = os;
      bw = ow;
    }
  }
  if (lane == 0) {
    red_s[warp] = bs;
    red_w[warp] = bw;
  }
  __syncthreads();
  if (tid == 0) {
    for (int i = 1; i < kGridWarps; ++i) {
      if (better_sw(red_s[i], red_w[i], bs, bw)) {
        bs = red_s[i];
        bw = red_w[i];
      }
    }
    int32_t* si = g.i + blockIdx.x * kSumInts;
    T* sv = g.v + blockIdx.x * kSumVals;
    si[0] = blk_f;
    si[1] = blk_b;
    si[2] = bw;
    sv[0] = bs;
    for (int j = 0; j < min(blk_b, kMaxSkip); ++j) {
      si[3 + j] = bad_w[j];
      sv[1 + j] = bad_s[j];
    }
  }
  cooperative_groups::this_grid().sync();
  if (blockIdx.x != 0 || warp != 0) return false;
  out = grid_combine<T>(src, g, nb, span, C, limit, n_dry);
  return lane == 0;
}

// One cooperative launch of `kern(arg)` over the walk of C positions:
// as many blocks of kGridThreads as the card holds at once, up to one
// for each kGridThreads positions.  `cache` (64 ints, zero at first)
// keeps the card's capacity for `kern` a device.
template <typename Arg>
inline cudaError_t launch_grid(void (*kern)(Arg), const Arg& arg, int C,
                               int device, int* cache, cudaStream_t s) {
  int capacity = device >= 0 && device < 64 ? cache[device] : 0;
  if (capacity <= 0) {
    int per_sm = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kern, kGridThreads, 0);
    if (err != cudaSuccess) return err;
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return err;
    capacity = per_sm * sms;
    if (device >= 0 && device < 64) cache[device] = capacity;
  }
  const int blocks = min((C + kGridThreads - 1) / kGridThreads, capacity);
  if (blocks < 1) return cudaErrorCooperativeLaunchTooLarge;
  void* kargs[] = {const_cast<Arg*>(&arg)};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kern), dim3(blocks), dim3(kGridThreads),
      kargs, 0, s);
  // a refused launch also sets the runtime's last error: clear it, or
  // the next launch's check would report it again
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

}  // namespace nk
