// Kernel K1: one select — the shuffled limited walk over every node's
// score — for the CUDA stack's count-1 selects, look-ahead misses and
// policy-weighted selects, in two launch shapes of one source.
//
// Replaces the JAX program nomad_tpu/ops/score.py:268
// score_and_select_packed (via score_and_select :257, _score_vectors
// :110 with its policy branch :163-180, _limited_walk_argmax :186,
// _pow10 :69).  Plain twin: nomad_tpu_torch/ops/score.py
// score_and_select_twin.
//
// Policy-weighted selects (a job with a resolved PolicySpec) pass the
// pre-scaled throughput and migration columns; a null pointer means the
// group is absent, and with both absent the kernel is the policy-off
// instantiation.  Such a select walks every candidate (limit INT32_MAX).
//
// (a) The prefix walk, for a select whose walk may stop early: one block
// of picks.cuh's step machinery (256 threads, steps of 64 positions
// doubling to 512) with one pick and no rotation.  It walks
// walk positions 0, 1, ... of all C; a thread reads its positions' rows
// through `perm` (coalesced), the cheap test's columns (static
// feasibility, cpu fit) and, only for a row that passes it, the rest of
// its columns and its score; the walk stops after the step holding the
// limit-th non-diverted feasible position (picks.cuh says why that keeps
// the full walk's bits).  With `count` set the block then sweeps the
// positions it did not walk with the feasibility test alone (no pows)
// for `feasible_count`; the stack's packed select, which reads only the
// row and the pulls, leaves it unset.
//
// (b) The grid, for a select that consumes the region: one cooperative
// launch of blocks of kGridThreads, block b scoring the walk positions
// [b * span, (b + 1) * span), a thread a contiguous run, in the same
// test-then-score order.  Each block writes a summary: its feasible and
// bad counts, its first kMaxSkip bad positions (score, position), and
// its best (score, position) over its other feasible positions, the
// earlier position first on a tie.  After one grid barrier the first warp
// of block 0 combines the summaries in block order.  Prefix counts over
// the blocks give every block the feasible and bad positions before it,
// hence which of its first bad positions are among the walk's first
// kMaxSkip (diverted) and which compete as non-diverted, the
// non-diverted count, and the block that holds the limit-th
// non-diverted position if there is one; the warp rescans that block's
// positions from the walk scratch (flags and scores, no pows) for their
// emit orders below the limit and the limit-th position, and takes no
// later block.  The diverted positions compete last, with their orders
// from the totals, two of them reversed behind a good node.
//
// Exactness: both shapes score a position with walk.cuh's score_node,
// every float op in the JAX program's order (-fmad=false, the one fma XLA
// forms written out, 10^x as pow in double rounded through float).  A
// non-diverted position's emit order is its rank among them, so it grows
// with the walk position: the best (score, position) with the earlier
// position on a tie is the best (score, order) over non-diverted
// positions, across blocks as within one.  A diverted position's order
// is at least the non-diverted count, above every non-diverted order.
//
// The rule: (b) iff limit >= n_candidates, else (a).  A limit below the
// candidates lets the walk stop early, and the path's count-1 select
// (limit 14, ~20 of 10,000 positions) takes 0.0038 ms on (a) against
// 0.0117 on (b); a limit of n_candidates or more is a whole-region
// select, every policy-path select among them: 0.0117 ms on (b) against
// 0.119 on (a).  A limited walk that runs long (40 feasible nodes of
// 10,000 at limit 14: 3,549 positions) takes 0.023 ms on (a) and 0.009
// on (b), but only the walk itself can tell how long it runs, so it
// stays on (a).  (picks_timing.py, profiled, with copies of the port whose
// rule takes one shape always; PERF.md §6 row 1.)
//
// Outputs: out_i [4] = row, pulls, feasible_count (-1 where (a) ran
// without `count`), walked (positions scored or tested: (a) its steps'
// extent, (b) all C); out_best; in the walk scratch, the flags
// (kFeasible | kBad) of every walked position and the score of every
// feasible one, in walk order.
//
// What bounds it on an H100: (a) one SM's dependent chain a step (perm
// -> cheap test -> rest -> two pows -> one barrier and a warp scan) for
// the one or two steps a short walk takes; (b) one position's chain on a
// grid of C / 128 blocks, the block's scan and reduction, one grid
// barrier (~1.1 us) and the combining warp's pass over the summaries.
// The least traffic is the reached rows' columns: at C = 16,384 in f64
// (b) reads about 1.4 MB, ~0.4 us at 3.35 TB/s; a short (a) walk a few
// KB.
//
// Launch: (a) one block on the caller's stream; (b) a cooperative grid
// as large as the card holds, up to C / kGridThreads blocks.  Nothing is
// allocated here (the wrapper passes C-long walk scratch and, for (b)
// alone, the summaries) and nothing is synchronised.

#include <cooperative_groups.h>

#include "picks.cuh"

// Mirrored field for field by the ctypes Structure in ops/_cuda.py.
struct ScoreSelectArgs {
  const void* cpu_total;
  const void* mem_total;
  const void* disk_total;
  const void* cpu_used;
  const void* mem_used;
  const void* disk_used;
  const void* feasible;    // uint8 [C]
  const void* collisions;  // int32 [C]
  const void* penalty;     // uint8 [C]
  const void* affinity;
  const void* spread;
  const void* perm;        // int32 [C]
  const void* tput_term;   // T [C] or null (no throughput group)
  const void* mig_term;    // T [C] or null (no migration group)
  void* s_scratch;         // T [C]: scores in walk order
  void* f_scratch;         // uint8 [C]: flags in walk order
  void* summary;           // (b): nk_select_summary_bytes(C, sizeof(T),
                           // limit, n_candidates); null for (a)
  void* out_i;             // int32 [4]: row, pulls, feasible_count, walked
  void* out_best;          // T [1]
  double ask_cpu;
  double ask_mem;
  double ask_disk;
  double has_tput;         // the throughput term's count
  int desired;
  int limit;
  int n_candidates;
  int C;
  int spread_fit;
  int is_f64;
  int device;
  int count;   // (a): count the feasible positions it did not walk
};

namespace {

namespace cg = cooperative_groups;

constexpr int kGridThreads = 128;
constexpr int kGridWarps = kGridThreads / 32;
constexpr int kSumInts = 8;  // feasible, bad, best_w, bad_w[3], 2 spare
constexpr int kSumVals = 4;  // best_s, bad_s[3]
constexpr int kNone = nk::kInt32Max;  // no position

template <typename T>
struct Cols {
  const T* __restrict__ cpu_total;
  const T* __restrict__ mem_total;
  const T* __restrict__ disk_total;
  const T* __restrict__ cpu_used;
  const T* __restrict__ mem_used;
  const T* __restrict__ disk_used;
  const uint8_t* __restrict__ feasible;
  const int32_t* __restrict__ collisions;
  const uint8_t* __restrict__ penalty;
  const T* __restrict__ affinity;
  const T* __restrict__ spread;
  const int32_t* __restrict__ perm;
  const T* __restrict__ tput_term;
  const T* __restrict__ mig_term;
  T* s_walk;
  uint8_t* f_walk;
  int32_t* sum_i;  // [blocks, kSumInts]
  T* sum_v;        // [blocks, kSumVals]
  int32_t* out_i;
  T* out_best;
  T ask_cpu, ask_mem, ask_disk, desired, has_tput;
  int limit, n_candidates, C;
  bool spread_fit, count;
};

__host__ __device__ inline size_t summary_bytes(int C, size_t t_size) {
  const size_t blocks = (static_cast<size_t>(C) + kGridThreads - 1) /
                        kGridThreads;
  return blocks * (kSumInts * sizeof(int32_t) + kSumVals * t_size);
}

__device__ __forceinline__ uint8_t walk_flag(bool f, bool bad) {
  return f ? static_cast<uint8_t>(nk::kFeasible | (bad ? nk::kBad : 0)) : 0;
}

// The best key over positions: higher score, then the earlier position.
template <typename T>
__device__ __forceinline__ bool better_sw(T s, int w, T bs, int bw) {
  return s > bs || (s == bs && w < bw);
}

// The rest of row `row` once its cheap test (static feasibility, cpu
// fit) passed: mem and disk fit, then the score.
template <typename T, bool kPolicy>
__device__ __forceinline__ void select_rest(const Cols<T>& c, int row,
                                            T cpu_total, T cpu_after, T& s,
                                            bool& f) {
  const T mem_total = __ldg(c.mem_total + row);
  const T mem_after = __ldg(c.mem_used + row) + c.ask_mem;
  const T disk_after = __ldg(c.disk_used + row) + c.ask_disk;
  f = (mem_after <= mem_total) & (disk_after <= __ldg(c.disk_total + row));
  if (!f) return;
  nk::PolicyNode<T> pol;
  if (kPolicy) {
    pol.tput_on = c.tput_term != nullptr;
    pol.tput = pol.tput_on ? __ldg(c.tput_term + row) : T(0);
    pol.has_tput = c.has_tput;
    pol.mig_on = c.mig_term != nullptr;
    pol.mig = pol.mig_on ? __ldg(c.mig_term + row) : T(0);
  }
  s = nk::score_node<T, true, false, kPolicy>(
      cpu_total, mem_total, cpu_after, mem_after, __ldg(c.collisions + row),
      __ldg(c.penalty + row) != 0, __ldg(c.affinity + row),
      __ldg(c.spread + row), c.desired, c.spread_fit, T(0), false, pol);
}

// Row `row`'s feasibility (and, when feasible, its score in `s`).
template <typename T, bool kPolicy>
__device__ __forceinline__ bool select_position(const Cols<T>& c, int row,
                                                T& s) {
  const T cpu_total = __ldg(c.cpu_total + row);
  const T cpu_after = __ldg(c.cpu_used + row) + c.ask_cpu;
  bool f = (__ldg(c.feasible + row) != 0) & (cpu_after <= cpu_total);
  if (f) select_rest<T, kPolicy>(c, row, cpu_total, cpu_after, s, f);
  return f;
}

// (a)'s source: walk position p is permuted position p.
template <typename T, bool kPolicy>
struct SelectSource {
  const Cols<T>& c;

  // nothing to remember after the count ballots
  __device__ __forceinline__ void note(int, int, bool, bool) {}

  template <int W>
  __device__ __forceinline__ void step(const int (&p)[W],
                                       const bool (&valid)[W], int, bool,
                                       T (&s)[W], bool (&f)[W]) {
    int row[W];
#pragma unroll
    for (int r = 0; r < W; ++r) row[r] = valid[r] ? __ldg(c.perm + p[r]) : 0;
    T cpu_total[W];
    T cpu_after[W];
#pragma unroll
    for (int r = 0; r < W; ++r) {
      f[r] = false;
      s[r] = T(0);
      if (valid[r]) {
        f[r] = __ldg(c.feasible + row[r]) != 0;
        cpu_total[r] = __ldg(c.cpu_total + row[r]);
        cpu_after[r] = __ldg(c.cpu_used + row[r]) + c.ask_cpu;
      }
    }
#pragma unroll
    for (int r = 0; r < W; ++r) {
      if (valid[r] && f[r]) {
        f[r] = cpu_after[r] <= cpu_total[r];
        if (f[r]) {
          select_rest<T, kPolicy>(c, row[r], cpu_total[r], cpu_after[r],
                                  s[r], f[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < W; ++r) {
      if (valid[r]) {
        c.f_walk[p[r]] = walk_flag(f[r], s[r] <= T(0));
        if (f[r]) c.s_walk[p[r]] = s[r];
      }
    }
  }
};

template <typename T, bool kPolicy>
__global__ void __launch_bounds__(nk::kPickThreads)
    select_prefix_kernel(const Cols<T> c) {
  __shared__ nk::PickShared<T> sh;
  __shared__ int red[nk::kPickWarps];
  SelectSource<T, kPolicy> src{c};
  const nk::WalkEnd<T> r =
      nk::prefix_walk<T>(src, sh, c.C, 0, c.limit, c.n_candidates);
  int feasible = r.feasible;
  if (c.count) {
    // the positions the walk did not reach: feasibility alone
    int mine = 0;
    for (int w = r.walked + threadIdx.x; w < c.C;
         w += nk::kPickThreads) {
      const int row = __ldg(c.perm + w);
      mine += (__ldg(c.feasible + row) != 0) &
              (__ldg(c.cpu_used + row) + c.ask_cpu <=
               __ldg(c.cpu_total + row)) &
              (__ldg(c.mem_used + row) + c.ask_mem <=
               __ldg(c.mem_total + row)) &
              (__ldg(c.disk_used + row) + c.ask_disk <=
               __ldg(c.disk_total + row));
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) mine += __shfl_down_sync(nk::kFull, mine, d);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = mine;
    __syncthreads();
    for (int i = 0; i < nk::kPickWarps; ++i) feasible += red[i];
  }
  if (threadIdx.x == 0) {
    c.out_i[0] = r.win_w >= 0 ? c.perm[r.win_w] : nk::kNoNode;
    c.out_i[1] = r.pulls;
    c.out_i[2] = c.count ? feasible : -1;
    c.out_i[3] = r.walked;
    c.out_best[0] = r.best;
  }
}

// (b)'s combine: the first warp of block 0, after the grid barrier.
template <typename T>
__device__ void combine(const Cols<T>& c, int nb, int span) {
  __shared__ T div_s[nk::kMaxSkip];
  __shared__ int div_w[nk::kMaxSkip];
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
    lf += __ldcg(c.sum_i + b * kSumInts);
    lb += __ldcg(c.sum_i + b * kSumInts + 1);
  }
  int inc_f = lf;
  int inc_b = lb;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int yf = __shfl_up_sync(nk::kFull, inc_f, d);
    const int yb = __shfl_up_sync(nk::kFull, inc_b, d);
    if (lane >= d) {
      inc_f += yf;
      inc_b += yb;
    }
  }
  const int f_tot = __shfl_sync(nk::kFull, inc_f, 31);
  const int b_tot = __shfl_sync(nk::kFull, inc_b, 31);
  const int nd_count = f_tot - min(b_tot, nk::kMaxSkip);
  const bool stop = nd_count >= c.limit;
  T bs = -INFINITY;
  int bw = kNone;
  int fb = inc_f - lf;  // feasible positions before block b
  int bb = inc_b - lb;  // bad positions before block b
  for (int b = b0; b < b1; ++b) {
    const int32_t* si = c.sum_i + b * kSumInts;
    const T* sv = c.sum_v + b * kSumVals;
    const int fa = fb + __ldcg(si);
    const int ba = bb + __ldcg(si + 1);
    const int nd_before = fb - min(bb, nk::kMaxSkip);
    const int nd_after = fa - min(ba, nk::kMaxSkip);
    // every non-diverted position of the block is emitted
    const bool all_in = !stop || nd_after < c.limit;
    for (int j = 0; j < min(ba - bb, nk::kMaxSkip); ++j) {
      const T s = __ldcg(sv + 1 + j);
      const int w = __ldcg(si + 3 + j);
      if (bb + j < nk::kMaxSkip) {
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
    } else if (nd_before < c.limit) {
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
    // in walk order from its flags and scores
    const int lo = held[0] * span;
    const int hi = min(lo + span, c.C);
    int run_f = held[1];
    int run_b = held[2];
    for (int base = lo; base < hi; base += 32) {
      const int w = base + lane;
      const uint8_t fl = w < hi ? __ldcg(c.f_walk + w) : 0;
      const bool f = (fl & nk::kFeasible) != 0;
      const bool bad = (fl & nk::kBad) != 0;
      const unsigned fm = __ballot_sync(nk::kFull, f);
      const unsigned bm = __ballot_sync(nk::kFull, bad);
      const int fbf = run_f + __popc(fm & below);
      const int bbf = run_b + __popc(bm & below);
      if (f && !(bad && bbf < nk::kMaxSkip)) {
        const int ord = fbf - min(bbf, nk::kMaxSkip);
        if (ord < c.limit) {
          const T s = __ldcg(c.s_walk + w);
          if (better_sw(s, w, bs, bw)) {
            bs = s;
            bw = w;
          }
        }
        if (ord + 1 == c.limit) lth = w;
      }
      run_f += __popc(fm);
      run_b += __popc(bm);
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const T os = __shfl_down_sync(nk::kFull, bs, d);
    const int ow = __shfl_down_sync(nk::kFull, bw, d);
    lth = max(lth, __shfl_down_sync(nk::kFull, lth, d));
    if (better_sw(os, ow, bs, bw)) {
      bs = os;
      bw = ow;
    }
  }
  if (lane != 0) return;
  // a non-diverted order is below every diverted one
  int best_ord = bw != kNone ? -1 : nk::kInt32Max;
  int win = bw != kNone ? bw : -1;
  if (!stop) {
    const int n_div = min(b_tot, nk::kMaxSkip);
    const bool reverse = (n_div == 2) && (nd_count > 0);
    for (int r = 0; r < n_div; ++r) {
      const int ord = nd_count + (reverse ? 1 - r : r);
      if (ord < c.limit && nk::better(div_s[r], ord, bs, best_ord)) {
        bs = div_s[r];
        best_ord = ord;
        win = div_w[r];
      }
    }
  }
  c.out_i[0] = win >= 0 ? c.perm[win] : nk::kNoNode;
  c.out_i[1] = stop ? lth + 1 : c.n_candidates;
  c.out_i[2] = f_tot;
  c.out_i[3] = c.C;
  c.out_best[0] = bs;
}

template <typename T, bool kPolicy>
__global__ void __launch_bounds__(kGridThreads)
    select_grid_kernel(const Cols<T> c) {
  __shared__ int scan[2][kGridWarps];
  __shared__ T bad_s[nk::kMaxSkip];
  __shared__ int bad_w[nk::kMaxSkip];
  __shared__ T red_s[kGridWarps];
  __shared__ int red_w[kGridWarps];
  const int nb = gridDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int span = (c.C + nb - 1) / nb;
  const int run = (span + kGridThreads - 1) / kGridThreads;
  const int lo = min(static_cast<int>(blockIdx.x) * span, c.C);
  const int hi = min(lo + span, c.C);
  const int t_lo = min(lo + tid * run, hi);
  const int t_hi = min(t_lo + run, hi);
  // score the thread's run; flags and scores into the walk scratch
  int nf = 0;
  int nbad = 0;
  for (int w = t_lo; w < t_hi; ++w) {
    T s = T(0);
    const bool f = select_position<T, kPolicy>(c, __ldg(c.perm + w), s);
    const bool bad = f && s <= T(0);
    c.f_walk[w] = walk_flag(f, bad);
    if (f) c.s_walk[w] = s;
    nf += f;
    nbad += bad;
  }
  // the block's exclusive prefix of (feasible, bad) over its threads
  int inc_f = nf;
  int inc_b = nbad;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int yf = __shfl_up_sync(nk::kFull, inc_f, d);
    const int yb = __shfl_up_sync(nk::kFull, inc_b, d);
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
  // the block's first kMaxSkip bad positions aside; the best of the rest
  T bs = -INFINITY;
  int bw = kNone;
  for (int w = t_lo; w < t_hi; ++w) {
    const uint8_t fl = c.f_walk[w];
    if (!(fl & nk::kFeasible)) continue;
    const T s = c.s_walk[w];
    if (fl & nk::kBad) {
      ++rank;
      if (rank <= nk::kMaxSkip) {
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
    const T os = __shfl_down_sync(nk::kFull, bs, d);
    const int ow = __shfl_down_sync(nk::kFull, bw, d);
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
    int32_t* si = c.sum_i + blockIdx.x * kSumInts;
    T* sv = c.sum_v + blockIdx.x * kSumVals;
    si[0] = blk_f;
    si[1] = blk_b;
    si[2] = bw;
    sv[0] = bs;
    for (int j = 0; j < min(blk_b, nk::kMaxSkip); ++j) {
      si[3 + j] = bad_w[j];
      sv[1 + j] = bad_s[j];
    }
  }
  cg::this_grid().sync();
  if (blockIdx.x == 0 && warp == 0) combine<T>(c, nb, span);
}

template <typename T>
Cols<T> typed(const ScoreSelectArgs& a) {
  Cols<T> c;
  c.cpu_total = static_cast<const T*>(a.cpu_total);
  c.mem_total = static_cast<const T*>(a.mem_total);
  c.disk_total = static_cast<const T*>(a.disk_total);
  c.cpu_used = static_cast<const T*>(a.cpu_used);
  c.mem_used = static_cast<const T*>(a.mem_used);
  c.disk_used = static_cast<const T*>(a.disk_used);
  c.feasible = static_cast<const uint8_t*>(a.feasible);
  c.collisions = static_cast<const int32_t*>(a.collisions);
  c.penalty = static_cast<const uint8_t*>(a.penalty);
  c.affinity = static_cast<const T*>(a.affinity);
  c.spread = static_cast<const T*>(a.spread);
  c.perm = static_cast<const int32_t*>(a.perm);
  c.tput_term = static_cast<const T*>(a.tput_term);
  c.mig_term = static_cast<const T*>(a.mig_term);
  c.s_walk = static_cast<T*>(a.s_scratch);
  c.f_walk = static_cast<uint8_t*>(a.f_scratch);
  const size_t blocks =
      (static_cast<size_t>(a.C) + kGridThreads - 1) / kGridThreads;
  c.sum_i = static_cast<int32_t*>(a.summary);
  c.sum_v = c.sum_i != nullptr
                ? reinterpret_cast<T*>(c.sum_i + blocks * kSumInts)
                : nullptr;
  c.out_i = static_cast<int32_t*>(a.out_i);
  c.out_best = static_cast<T*>(a.out_best);
  // host doubles round to T here exactly as the twin's torch.as_tensor
  c.ask_cpu = static_cast<T>(a.ask_cpu);
  c.ask_mem = static_cast<T>(a.ask_mem);
  c.ask_disk = static_cast<T>(a.ask_disk);
  c.desired = static_cast<T>(a.desired);
  c.has_tput = static_cast<T>(a.has_tput);
  c.limit = a.limit;
  c.n_candidates = a.n_candidates;
  c.C = a.C;
  c.spread_fit = a.spread_fit != 0;
  c.count = a.count != 0;
  return c;
}

// The most blocks of `kern` the card holds at once, cached a device.
template <typename T, bool kPolicy>
cudaError_t grid_capacity(int device, int* out) {
  static int cache[64] = {0};
  if (device >= 0 && device < 64 && cache[device] > 0) {
    *out = cache[device];
    return cudaSuccess;
  }
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, select_grid_kernel<T, kPolicy>, kGridThreads, 0);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  *out = per_sm * sms;
  if (device >= 0 && device < 64) cache[device] = *out;
  return cudaSuccess;
}

// The rule (the header's): the grid iff the limit reaches the
// candidates.  nk_select_summary_bytes reports it to the wrapper, which
// passes the summaries to the grid alone.
inline bool takes_grid(int limit, int n_candidates) {
  return limit >= n_candidates;
}

template <typename T, bool kPolicy>
cudaError_t launch(const ScoreSelectArgs& a, cudaStream_t s) {
  const Cols<T> c = typed<T>(a);
  if (!takes_grid(a.limit, a.n_candidates)) {
    select_prefix_kernel<T, kPolicy>
        <<<1, nk::kPickThreads, 0, s>>>(c);
    return cudaGetLastError();
  }
  if (a.summary == nullptr) return cudaErrorInvalidValue;
  int capacity = 0;
  cudaError_t err = grid_capacity<T, kPolicy>(a.device, &capacity);
  if (err != cudaSuccess) return err;
  const int blocks = min((a.C + kGridThreads - 1) / kGridThreads, capacity);
  if (blocks < 1) return cudaErrorCooperativeLaunchTooLarge;
  void* kargs[] = {const_cast<Cols<T>*>(&c)};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(select_grid_kernel<T, kPolicy>),
      dim3(blocks), dim3(kGridThreads), kargs, 0, s);
  // a refused launch also sets the runtime's last error: clear it, or
  // the next launch's check would report it again
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

}  // namespace

extern "C" int nk_score_select(ScoreSelectArgs* a, void* stream) {
  if (a->C < 1 || a->limit < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(a->device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool policy = a->tput_term != nullptr || a->mig_term != nullptr;
  if (a->is_f64) {
    err = policy ? launch<double, true>(*a, s) : launch<double, false>(*a, s);
  } else {
    err = policy ? launch<float, true>(*a, s) : launch<float, false>(*a, s);
  }
  return static_cast<int>(err);
}

// Bytes of (b)'s per-block summaries for a C-row select with this limit
// and candidate count: 0 where the rule takes (a), which reads none.
extern "C" size_t nk_select_summary_bytes(int C, int t_size, int limit,
                                          int n_candidates) {
  return takes_grid(limit, n_candidates)
             ? summary_bytes(C, static_cast<size_t>(t_size))
             : 0;
}

extern "C" const char* nk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
