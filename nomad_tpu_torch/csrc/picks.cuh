// The prefix walk, shared by kernels K1 (score_select.cu) and K6
// (walk_only.cu) in their one-pick shape, K2 (plan_picks.cu), K7
// (batch_picks.cu), and K9 (chained_batch.cu) and K10 (batch_plan.cu)
// through chained_prefix.cuh: one block walks a pick in steps and reads
// or scores only the positions the pick reaches.  The step machinery
// (`prefix_walk`) takes a source that gives a step's positions' scores
// and feasibility; K2's and K7's source, their carry and their P picks
// an eval (`run_eval`) follow it here.
//
// Replaces the pick scan of nomad_tpu/ops/batch.py _run_picks (:347)
// for a single group (T = 1, no spread, deltas, ports or devices), as
// plan_picks_full (:766) and plan_picks (:735) run it, with the walk of
// _walk (:281) and _rotated_prefix (:268).
//
// Walk position w of a pick is permuted position (offset + w) mod
// n_cand; tail positions (>= n_cand) are never feasible and never
// rotate, so they are not walked (K1 and K6 walk all C positions without
// a rotation).  The block walks in steps: a pick's first step covers
// kPickFirst positions and each next one twice as many, up to
// kPickThreads * kPickWide, position base + r * kPickThreads + t on
// thread t.  In K2's and K7's source a thread reads its positions' rows
// through `perm` (coalesced), then the columns of a cheap test (static
// feasibility and cpu fit) through the read-only path, and only for a
// row that passes it the rest of its columns and its score.  Warp
// ballots and one table of per-(sub-step, warp) counts give every
// position its feasible and bad ranks.  Across steps the block carries
// the running feasible and bad counts, each thread its best (score,
// emit order, position) over the non-diverted positions with order <
// limit, and shared memory the diverted positions (the first kMaxSkip
// bad ones) and the walk position of the limit-th non-diverted node.
//
// Why a prefix gives the full walk's bits (walk.cuh limited_walk): a
// non-diverted feasible position's emit order is its rank among them, a
// diverted one's nd_count + r (or 1 - r) >= nd_count.  Once the
// non-diverted count reaches `limit`, only orders < limit compete, so
// the winner is one of the first `limit` non-diverted positions, all at
// or before the limit-th (pulls = lth + 1); whether a position is
// diverted is a prefix count of bad positions.  The walk stops after
// that step.  Otherwise it consumes the region (pulls = n_cand, K1's
// n_candidates) and the diverted positions compete at the end with their
// orders from the totals.
//
// The carry: positions an earlier pick of the eval won are marked in a
// bitmap of n_cand bits; for each, a list entry (first-won order) holds
// its usage and collisions, updated as x = x + ask in pick order, the
// twin's order of additions.  A position's score and feasibility depend
// only on its row, the eval's ask and count, and its usage and
// collisions, which change only when it is won.  So a scored position
// is marked known (with its feasibility in a third bitmap and, when
// feasible, its score in the eval's score cache), a later pick reads it
// back instead of rescoring it, and a win clears the mark: a walk that
// passes a position again (a long walk, every pick) pays its dependent
// row loads and pows once an eval.  Only a walk's steps of kPickThreads
// or more positions record: a short walk's marks would cost more than
// any later pick reads back.  The bitmaps and the list live in dynamic
// shared memory, or in a per-eval slice of global scratch where they do
// not fit; the score cache, n_cand values of T an eval, in global
// scratch (written only where scored).  After the first failed pick the
// rest are inert (rows -1, pulls 0), as in the JAX scan.
#pragma once

#include "walk.cuh"

namespace nk {

// The walk's shape, chosen on the card (PERF.md §6): K2's block and
// each of K7's blocks run kPickThreads threads; a pick's first step
// covers kPickFirst positions, each next one twice as many up to
// kPickWide positions a thread.  K1's prefix walk and K9's block take
// the same shape, and so do K6's and K10's.
constexpr int kPickThreads = 256;
constexpr int kPickWarps = kPickThreads / 32;
constexpr int kPickFirst = 64;
constexpr int kPickWide = 2;
constexpr int kPickWidest = kPickThreads * kPickWide;
// the step's table of (sub-step, warp) counts, spread over a warp's lanes
constexpr int kTableLane = (kPickWide * kPickWarps + 31) / 32;
static_assert(kPickThreads % 32 == 0 && kPickThreads <= 1024,
              "whole warps, one block");
static_assert(kPickFirst >= 1 && kPickWide >= 1, "a step covers positions");

template <typename T>
struct Picks {
  // node-space inputs; collisions, penalty and affinity may be null
  // (all zero)
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
  const int32_t* __restrict__ perm;
  T* scores;       // [n_cand]: the eval's score cache
  int32_t* rows;   // [n_picks]
  int32_t* pulls;  // [n_picks], or null
  T ask_cpu, ask_mem, ask_disk, desired;
  int limit, n_cand, n_picks;
  bool distinct_hosts, spread_fit;
};

// A carry of at most this many bytes lives in dynamic shared memory;
// a larger one in the global scratch the wrapper passes, sized by the
// library's nk_pick_carry_bytes and nk_pick_carry_smem_max.
constexpr size_t kCarrySmemMax = 64 * 1024;

// One eval's carry over its picks (see the header comment).
template <typename T>
struct Carry {
  T* cpu;          // [n_picks]
  T* mem;
  T* disk;
  int32_t* pos;    // [n_picks]: permuted position of each entry
  int32_t* coll;   // [n_picks]
  uint32_t* won;   // [ceil(n_cand / 32)] each
  uint32_t* known;
  uint32_t* feas;
};

// Bytes of one eval's carry, a multiple of 16.
__host__ __device__ inline size_t carry_bytes(int n_cand, int n_picks,
                                              size_t t_size) {
  const size_t words = (static_cast<size_t>(n_cand) + 31) / 32;
  const size_t b = 3 * static_cast<size_t>(n_picks) * t_size +
                   8 * static_cast<size_t>(n_picks) + 12 * words;
  return (b + 15) & ~static_cast<size_t>(15);
}

template <typename T>
__device__ inline Carry<T> bind_carry(unsigned char* base, int n_cand,
                                      int n_picks) {
  Carry<T> c;
  const size_t p = static_cast<size_t>(n_picks);
  const int words = (n_cand + 31) / 32;
  c.cpu = reinterpret_cast<T*>(base);
  c.mem = c.cpu + p;
  c.disk = c.mem + p;
  c.pos = reinterpret_cast<int32_t*>(c.disk + p);
  c.coll = c.pos + p;
  c.won = reinterpret_cast<uint32_t*>(c.coll + p);
  c.known = c.won + words;
  c.feas = c.known + words;
  return c;
}

__device__ __forceinline__ bool bit(const uint32_t* m, int p) {
  return (m[p >> 5] >> (p & 31)) & 1u;
}

// Sets bit p of `m` for the lanes of `mask`, whose positions `p` are
// the warp's consecutive run from lane 0's unless that run wraps past
// n_cand: then each lane sets its own.  Every lane of the warp calls it.
__device__ __forceinline__ void set_bits(uint32_t* m, unsigned mask, int p,
                                         int n_cand) {
  const int p0 = __shfl_sync(kFull, p, 0);
  if (mask == 0u) return;
  if (p0 + 31 < n_cand) {
    if ((threadIdx.x & 31) == 0) {
      const int sh = p0 & 31;
      atomicOr(&m[p0 >> 5], mask << sh);
      if (sh != 0) atomicOr(&m[(p0 >> 5) + 1], mask >> (32 - sh));
    }
  } else if ((mask >> (threadIdx.x & 31)) & 1u) {
    atomicOr(&m[p >> 5], 1u << (p & 31));
  }
}

// The block's walk state in static shared memory.
template <typename T>
struct PickShared {
  int counts[2][kPickWide * kPickWarps];  // feasible | bad << 16
  T div_s[kMaxSkip];
  int div_w[kMaxSkip];
  int lth;
  T red_s[kPickWarps];
  int red_ord[kPickWarps];
  int red_w[kPickWarps];
  int offset;
  int dead;
  int n_won;
};

// What one pick's walk gives: thread 0's winner (walk position, -1 for
// none), pulls and best score; every thread's count of walked positions
// (the steps' extent) and of the feasible ones among them.
template <typename T>
struct WalkEnd {
  int win_w;
  int pulls;
  T best;
  int walked;
  int feasible;
};

// Position p's entry in the carry list (p must be marked won).
template <typename T>
__device__ __forceinline__ int find_won(const Carry<T>& cr, int n_won, int p) {
  int i = 0;
  while (i < n_won - 1 && cr.pos[i] != p) ++i;
  return i;
}

// The rest of permuted position p's row once its cheap test passed
// (static feasibility and cpu fit): its score, and whether it is
// feasible.  `cpu` is its cpu usage (the carry's where it was won).
template <typename T>
__device__ __forceinline__ void score_rest(const Picks<T>& c,
                                           const Carry<T>& cr, int n_won,
                                           int p, int row, T cpu_total,
                                           T cpu, T& s, bool& f) {
  const T mem_total = __ldg(c.mem_total + row);
  const T disk_total = __ldg(c.disk_total + row);
  T mem = __ldg(c.mem_used + row);
  T disk = __ldg(c.disk_used + row);
  int coll = c.collisions != nullptr ? __ldg(c.collisions + row) : 0;
  const bool pen = c.penalty != nullptr && __ldg(c.penalty + row) != 0;
  const T aff = c.affinity != nullptr ? __ldg(c.affinity + row) : T(0);
  if (bit(cr.won, p)) {
    const int i = find_won(cr, n_won, p);
    mem = cr.mem[i];
    disk = cr.disk[i];
    coll = cr.coll[i];
  }
  const T cpu_after = cpu + c.ask_cpu;
  const T mem_after = mem + c.ask_mem;
  const T disk_after = disk + c.ask_disk;
  f = (mem_after <= mem_total) & (disk_after <= disk_total) &
      !(c.distinct_hosts & (coll > 0));
  if (f) {
    s = score_node<T, false>(cpu_total, mem_total, cpu_after, mem_after,
                             coll, pen, aff, T(0), c.desired, c.spread_fit);
  }
}

// One pick's prefix walk over walk positions [0, n_walk) from `offset`:
// walk position w is source position (offset + w) mod n_walk.  Every
// thread of the block calls it.  Step k covers min(kPickFirst * 2^k,
// kPickWidest) walk positions, position base + r * kPickThreads + t on
// thread t; `src.step(p, valid, R, record, s, f)` scores a step's source
// positions (each thread its kPickWide, of which the first R sub-steps
// hold positions), and it or `src.note(r, p, f, record)`, called for each
// such sub-step r after its count ballots, keeps what it likes where
// `record` is set (steps of kPickThreads positions or more).  A walk
// that does not stop consumes the region: its pulls are `n_dry`.
template <typename T, typename Src>
__device__ WalkEnd<T> prefix_walk(Src& src, PickShared<T>& sh, int n_walk,
                                  int offset, int limit, int n_dry) {
  constexpr int B = kPickThreads;
  constexpr int nw = kPickWarps;
  constexpr int W = kPickWide;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  int feas_run = 0;  // feasible positions walked, block-uniform
  int bad_run = 0;   // bad positions walked, block-uniform
  T best_s = -INFINITY;
  int best_ord = kInt32Max;
  int best_w = -1;
  bool stopped = false;
  int base = 0;
  int width = min(kPickFirst, kPickWidest);
  for (int step = 0; base < n_walk; ++step) {
    const int R = (width + B - 1) / B;
    int* tab = sh.counts[step & 1];
    int p[W];
    bool valid[W];
#pragma unroll
    for (int r = 0; r < W; ++r) {
      const int w = base + r * B + threadIdx.x;
      p[r] = offset + w;
      if (p[r] >= n_walk) p[r] -= n_walk;
      valid[r] = r < R && r * B + static_cast<int>(threadIdx.x) < width &&
                 w < n_walk;
    }
    T s[W];
    bool f[W];
    // a walk records what it scores only once a step gives every thread
    // a position: a short walk would pay for marks no later pick reads
    src.step(p, valid, R, width >= B, s, f);
    unsigned fmask[W];
    unsigned bmask[W];
#pragma unroll
    for (int r = 0; r < W; ++r) {
      if (r < R) {
        fmask[r] = __ballot_sync(kFull, f[r]);
        bmask[r] = __ballot_sync(kFull, f[r] && s[r] <= T(0));
        if (lane == 0) {
          tab[r * nw + warp] = __popc(fmask[r]) | (__popc(bmask[r]) << 16);
        }
        src.note(r, p[r], f[r], width >= B);
      }
    }
    __syncthreads();
    // the table's R * nw entries in walk order, (sub-step, warp), m to
    // a lane: one warp scan gives every entry's exclusive prefix
    const int n_ent = R * nw;
    const int m = (n_ent + 31) >> 5;
    int loc[kTableLane];
    int lane_sum = 0;
#pragma unroll
    for (int i = 0; i < kTableLane; ++i) {
      const int idx = lane * m + i;
      const int v = i < m && idx < n_ent ? tab[idx] : 0;
      loc[i] = lane_sum;
      lane_sum += v;
    }
    int incl = lane_sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += y;
    }
    const int lane_excl = incl - lane_sum;
    const int total = __shfl_sync(kFull, incl, 31);
#pragma unroll
    for (int r = 0; r < W; ++r) {
      if (r < R) {
        // entry (r, warp) lives at lane j / m, slot j % m (the same for
        // the whole warp)
        const int j = r * nw + warp;
        const int k = j - (j / m) * m;
        int mine = lane_excl + loc[0];
#pragma unroll
        for (int i = 1; i < kTableLane; ++i) {
          if (k == i) mine = lane_excl + loc[i];
        }
        const int excl = __shfl_sync(kFull, mine, j / m);
        if (f[r]) {
          const int w = base + r * B + threadIdx.x;
          const int feas_before =
              feas_run + (excl & 0xffff) + __popc(fmask[r] & below);
          const int bad_before =
              bad_run + (excl >> 16) + __popc(bmask[r] & below);
          const bool bad = ((bmask[r] >> lane) & 1u) != 0;
          if (bad && bad_before < kMaxSkip) {
            // diverted: its rank among the diverted is its bad rank
            sh.div_s[bad_before] = s[r];
            sh.div_w[bad_before] = w;
          } else {
            const int ord = feas_before - min(bad_before, kMaxSkip);
            if (ord < limit && better(s[r], ord, best_s, best_ord)) {
              best_s = s[r];
              best_ord = ord;
              best_w = w;
            }
            if (ord + 1 == limit) sh.lth = w;
          }
        }
      }
    }
    feas_run += total & 0xffff;
    bad_run += total >> 16;
    base += width;
    width = min(2 * width, kPickWidest);
    if (feas_run - min(bad_run, kMaxSkip) >= limit) {
      stopped = true;
      break;
    }
  }

  // the block's best key: a warp tree, then warp 0 over the warps
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const T os = __shfl_down_sync(kFull, best_s, d);
    const int oo = __shfl_down_sync(kFull, best_ord, d);
    const int ow = __shfl_down_sync(kFull, best_w, d);
    if (better(os, oo, best_s, best_ord)) {
      best_s = os;
      best_ord = oo;
      best_w = ow;
    }
  }
  if (lane == 0) {
    sh.red_s[warp] = best_s;
    sh.red_ord[warp] = best_ord;
    sh.red_w[warp] = best_w;
  }
  __syncthreads();
  WalkEnd<T> out;
  out.walked = min(base, n_walk);
  out.feasible = feas_run;
  out.win_w = -1;
  out.pulls = 0;
  out.best = -INFINITY;
  if (warp == 0) {
    best_s = lane < nw ? sh.red_s[lane] : T(-INFINITY);
    best_ord = lane < nw ? sh.red_ord[lane] : kInt32Max;
    best_w = lane < nw ? sh.red_w[lane] : -1;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      const T os = __shfl_down_sync(kFull, best_s, d);
      const int oo = __shfl_down_sync(kFull, best_ord, d);
      const int ow = __shfl_down_sync(kFull, best_w, d);
      if (better(os, oo, best_s, best_ord)) {
        best_s = os;
        best_ord = oo;
        best_w = ow;
      }
    }
    if (lane == 0) {
      if (stopped) {
        out.pulls = sh.lth + 1;
      } else {
        // the region is consumed: the diverted positions compete with
        // their orders from the totals
        out.pulls = n_dry;
        const int nd_count = feas_run - min(bad_run, kMaxSkip);
        const int n_div = min(bad_run, kMaxSkip);
        const bool reverse = (n_div == 2) && (nd_count > 0);
        for (int r = 0; r < n_div; ++r) {
          const int ord = nd_count + (reverse ? 1 - r : r);
          if (ord < limit && better(sh.div_s[r], ord, best_s, best_ord)) {
            best_s = sh.div_s[r];
            best_ord = ord;
            best_w = sh.div_w[r];
          }
        }
      }
      out.win_w = best_ord != kInt32Max ? best_w : -1;
      out.best = best_s;
    }
  }
  return out;
}

// The sum of `mine` over the block's kPickThreads threads: every thread
// calls it and gets the sum (K1's and K6's sweep of the positions a
// walk did not reach).
__device__ __forceinline__ int block_sum(int mine) {
  __shared__ int red[kPickWarps];
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) mine += __shfl_down_sync(kFull, mine, d);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = mine;
  __syncthreads();
  int sum = 0;
  for (int i = 0; i < kPickWarps; ++i) sum += red[i];
  return sum;
}

// K2's and K7's source: a position's score and feasibility from its
// row (read through `perm`), the eval's ask and count, and its usage and
// collisions (the carry's where it was won); or, where a wide step of an
// earlier pick scored it and no win changed it since, from the score
// cache.
template <typename T>
struct PickSource {
  const Picks<T>& c;
  const Carry<T>& cr;
  int n_won;
  bool cached;  // a walk has recorded scores (block-uniform)

  template <int W>
  __device__ __forceinline__ void step(const int (&p)[W],
                                       const bool (&valid)[W], int,
                                       bool record, T (&s)[W], bool (&f)[W]) {
    bool fresh[W];  // scored in this step
    int row[W];
    // the loads in three rounds, each over all of the thread's
    // positions: a known position's score from the cache, an unknown
    // one's perm entry (coalesced); then the cheap test's three columns;
    // then the rest of a row that passed it
#pragma unroll
    for (int r = 0; r < W; ++r) {
      const bool known = cached && valid[r] && bit(cr.known, p[r]);
      f[r] = known && bit(cr.feas, p[r]);
      s[r] = f[r] ? c.scores[p[r]] : T(0);
      fresh[r] = valid[r] && !known;
      row[r] = fresh[r] ? __ldg(c.perm + p[r]) : 0;
    }
    T cpu_total[W];
    T cpu[W];
#pragma unroll
    for (int r = 0; r < W; ++r) {
      if (fresh[r]) {
        f[r] = __ldg(c.feasible + row[r]) != 0;
        cpu_total[r] = __ldg(c.cpu_total + row[r]);
        cpu[r] = __ldg(c.cpu_used + row[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < W; ++r) {
      if (fresh[r] && f[r]) {
        if (bit(cr.won, p[r])) cpu[r] = cr.cpu[find_won(cr, n_won, p[r])];
        f[r] = cpu[r] + c.ask_cpu <= cpu_total[r];
        if (f[r]) {
          score_rest<T>(c, cr, n_won, p[r], row[r], cpu_total[r], cpu[r],
                        s[r], f[r]);
          if (f[r]) c.scores[p[r]] = s[r];
        }
      }
    }
#pragma unroll
    for (int r = 0; r < W; ++r) scored[r] = fresh[r];
    cached = cached || record;
  }

  // Remembers what sub-step r of the step scored, where `record` is set.
  // Called from the walk's count ballots, after the step's table entry:
  // marking the cache before the ballots lengthened a step's path to its
  // barrier (K2's and K7's long walks ran 2-4 % slower so).
  __device__ __forceinline__ void note(int r, int p, bool f, bool record) {
    if (record) {
      set_bits(cr.known, __ballot_sync(kFull, scored[r]), p, c.n_cand);
      set_bits(cr.feas, __ballot_sync(kFull, scored[r] && f), p, c.n_cand);
    }
  }

  bool scored[kPickWide];  // the last step's positions scored afresh
};

// The P picks of one eval, `carry` its carry bytes (shared or global).
// Writes rows[k] (and pulls[k]) for k in [0, n_picks).
template <typename T>
__device__ void run_eval(const Picks<T>& c, unsigned char* carry) {
  __shared__ PickShared<T> sh;
  const Carry<T> cr = bind_carry<T>(carry, c.n_cand, c.n_picks);
  const int words = (c.n_cand + 31) >> 5;
  // won, known and feas are one run of words
  for (int i = threadIdx.x; i < 3 * words; i += kPickThreads) cr.won[i] = 0u;
  if (threadIdx.x == 0) {
    sh.offset = 0;
    sh.dead = 0;
    sh.n_won = 0;
  }
  __syncthreads();
  const int n_cand = c.n_cand;
  PickSource<T> src{c, cr, 0, false, {}};
  for (int k = 0; k < c.n_picks; ++k) {
    const int offset = sh.offset;
    const int n_won = sh.n_won;
    src.n_won = n_won;
    const WalkEnd<T> walk =
        prefix_walk<T>(src, sh, n_cand, offset, c.limit, n_cand);
    const int win_w = walk.win_w;
    const int pulls = walk.pulls;
    if (threadIdx.x == 0) {
      if (win_w >= 0) {
        int p = win_w + offset;
        if (p >= n_cand) p -= n_cand;
        const int row = c.perm[p];
        c.rows[k] = row;
        int i;
        if (bit(cr.won, p)) {
          i = find_won(cr, n_won, p);
        } else {
          // first win of this position: its entry starts from the
          // node's base usage and collisions
          i = n_won;
          cr.pos[i] = p;
          cr.cpu[i] = c.cpu_used[row];
          cr.mem[i] = c.mem_used[row];
          cr.disk[i] = c.disk_used[row];
          cr.coll[i] = c.collisions != nullptr ? c.collisions[row] : 0;
          cr.won[p >> 5] |= 1u << (p & 31);
          sh.n_won = n_won + 1;
        }
        cr.cpu[i] = cr.cpu[i] + c.ask_cpu;
        cr.mem[i] = cr.mem[i] + c.ask_mem;
        cr.disk[i] = cr.disk[i] + c.ask_disk;
        cr.coll[i] = cr.coll[i] + 1;
        // its usage changed: the next pick that reaches it rescores it
        // (the bits are only ever set while a walk scores)
        cr.known[p >> 5] &= ~(1u << (p & 31));
        cr.feas[p >> 5] &= ~(1u << (p & 31));
      } else {
        c.rows[k] = kNoNode;
        sh.dead = 1;
      }
      if (c.pulls != nullptr) c.pulls[k] = pulls;
      sh.offset = (offset + pulls) % n_cand;
    }
    __syncthreads();
    if (sh.dead) {
      // the scheduler coalesces the group's later placements after its
      // first failure: the remaining picks are inert
      for (int j = k + 1 + threadIdx.x; j < c.n_picks; j += kPickThreads) {
        c.rows[j] = kNoNode;
        if (c.pulls != nullptr) c.pulls[j] = 0;
      }
      return;
    }
  }
}

// Launch `kern(arg)` on `grid` blocks of kPickThreads with the carry
// in `smem` bytes of dynamic shared memory (0 when it is in global
// scratch).
template <typename Arg>
inline cudaError_t launch_picks(void (*kern)(Arg), int grid, size_t smem,
                                cudaStream_t s, const Arg& arg) {
  if (grid < 1 || smem > kCarrySmemMax) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kern<<<grid, kPickThreads, smem, s>>>(arg);
  return cudaGetLastError();
}

}  // namespace nk
