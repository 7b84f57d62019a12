// The chain of kernel K9 (chained_batch.cu) as prefix walks: one block
// runs E evals x P picks, serially, and each pick walks only the prefix
// of its eval's walk order that it reaches, with picks.cuh's step
// machinery (`prefix_walk`) and a source of its own (`ChainSource`).
// Kernel K10 (batch_plan.cu) runs the same eval body in a per-eval mode
// (`kPerEval`): one block an eval, each over its own base usage, nothing
// chained.
//
// Replaces the eval scan of nomad_tpu/ops/batch.py:801
// chained_plan_picks (and :1262 chained_plan_picks_shared) with one
// group, its pick scan _run_picks (:347) and walk _walk (:281); in the
// per-eval mode the vmapped plan_picks (:735) of :1391 batch_plan_picks.
//
// No per-eval prologue: there is no inverse of the walk order and no
// gather of the candidate region.  Walk position w of pick k is permuted
// position (offset + w) mod n_cand; its row comes through perm[e]; the
// row's columns are read where they lie (node space, per-eval [E, C]
// columns at e * C, feasibility at the eval's stride, 0 for the shared
// mode).  Its usage is the chain's node-space carry (in the per-eval
// mode the eval's own base usage, row e of [E, C]), overlaid by the
// eval's own entries.
//
// State, in one carry (dynamic shared memory, or the wrapper's global
// scratch where it does not fit; in the per-eval mode one a block):
//   dirty    C bits by row, the launch: rows whose node-space usage
//            lives in *_out (the others still hold *_in; nothing copies
//            the arena in); unused in the per-eval mode
//   touched  C bits by row, the eval: rows with an entry
//   entries  2P at most (a pick's eviction row and its winner): row,
//            usage and collisions this eval, updated in pick order
//   known,   n_cand bits by walk position, the eval: positions whose
//   feas     score and feasibility sit in the score cache (T [C] by
//            position, global scratch; one a block in the per-eval
//            mode), as in K2
// and in global scratch pos_of (int32 [C] by row): the walk position at
// which a step recorded the row, held only while perm[e] maps it back
// to the row, so an eviction or a penalty row finds its position without
// an inverse of the walk order (the per-eval mode has neither).
//
// Where trouble lies, and what the design does about it:
//   * Two orders of additions.  Inside an eval a row's usage follows the
//     pick scan's own order, evictions and asks interleaved pick by pick:
//     pick k's eviction is added to its row's entry before pick k scores,
//     the winner's ask after.  The carry handed to the next eval is
//     rebuilt as the JAX program rebuilds it (chained.cuh
//     rebuild_carry): every successful pick's ask in pick order, then
//     every applied eviction in pick order, onto the node-space carry of
//     the eval's start.  In floating point the two differ, and both are
//     part of the result, so the entries never write the carry.
//   * Rows outside the candidate region.  An eviction or penalty row that
//     no walk position of the eval maps to changes nothing a walk reads:
//     its entry (or its penalty) is never looked up, and the eviction
//     reaches the node-space carry through the rebuild alone.
//   * Pre-deltas.  Thread 0 adds them to the node-space carry in row
//     order before the eval, as the JAX eval_step does (batch.py:843-849).
//   * The score cache holds only while a position's inputs change only
//     when it is won or evicted.  It is off for an eval with spread (a
//     win moves the boost of every node with the same attribute value)
//     or with per-pick scalars (not K9's layout); it is cleared at the
//     position of a row whose entry changes (a win; an eviction, found
//     through pos_of); it is bypassed at pick k's penalty rows: their
//     positions are cleared when the pick opens, so the walk scores them
//     afresh with the penalty, and a step does not record them, since
//     their penalty holds for that pick only.  As in K2 only a walk's
//     steps of kPickThreads positions or more record.
//   * Spread.  The per-slot spread state (combined use map, min and max)
//     is rebuilt a pick (chained.cuh spread_slots); each reached position
//     reads its own codes, sp_codes[e, s, row].  The state lives where
//     the Chain points it: K10 points each block at its own slice.
//
// Exactness: a position's score is score_position's (chained.cuh) for
// one group: every float op in the JAX program's order through
// walk.cuh's score_node; the walk's bits are picks.cuh's argument.
#pragma once

#include "chained.cuh"
#include "picks.cuh"

namespace nk {

template <typename T>
struct ChainCarry {
  T* cpu;         // [2P] an entry's usage this eval
  T* mem;
  T* disk;
  int32_t* row;   // [2P] an entry's row
  int32_t* coll;  // [2P] an entry's collisions this eval
  uint32_t* dirty;    // [words]
  uint32_t* touched;  // [words], then known and feas: one run
  uint32_t* known;
  uint32_t* feas;
};

// Bytes of the chain's carry, a multiple of 16.
__host__ __device__ inline size_t chain_carry_bytes(int C, int P,
                                                    size_t t_size) {
  const size_t words = (static_cast<size_t>(C) + 31) / 32;
  const size_t n = 2 * static_cast<size_t>(P);
  const size_t b = 3 * n * t_size + 8 * n + 16 * words;
  return (b + 15) & ~static_cast<size_t>(15);
}

template <typename T>
__device__ inline ChainCarry<T> bind_chain_carry(unsigned char* base, int C,
                                                 int P) {
  ChainCarry<T> cr;
  const size_t n = 2 * static_cast<size_t>(P);
  const size_t words = (static_cast<size_t>(C) + 31) / 32;
  cr.cpu = reinterpret_cast<T*>(base);
  cr.mem = cr.cpu + n;
  cr.disk = cr.mem + n;
  cr.row = reinterpret_cast<int32_t*>(cr.disk + n);
  cr.coll = cr.row + n;
  cr.dirty = reinterpret_cast<uint32_t*>(cr.coll + n);
  cr.touched = cr.dirty + words;
  cr.known = cr.touched + words;
  cr.feas = cr.known + words;
  return cr;
}

__device__ __forceinline__ void set_bit(uint32_t* m, int i) {
  m[i >> 5] |= 1u << (i & 31);
}

__device__ __forceinline__ void clear_bit(uint32_t* m, int i) {
  m[i >> 5] &= ~(1u << (i & 31));
}

// The node-space carry of one usage column at `row`.
template <typename T>
__device__ __forceinline__ T carry_at(const T* in, const T* out,
                                      const uint32_t* dirty, int row) {
  return bit(dirty, row) ? out[row] : __ldg(in + row);
}

// Adds (cpu, mem, disk) to the node-space carry at `row` (one thread).
template <typename T>
__device__ void add_carry(const Chain<T>& c, const ChainCarry<T>& cr,
                          int row, T cpu, T mem, T disk) {
  const T x = carry_at(c.cpu_in, c.cpu_out, cr.dirty, row) + cpu;
  const T y = carry_at(c.mem_in, c.mem_out, cr.dirty, row) + mem;
  const T z = carry_at(c.disk_in, c.disk_out, cr.dirty, row) + disk;
  c.cpu_out[row] = x;
  c.mem_out[row] = y;
  c.disk_out[row] = z;
  set_bit(cr.dirty, row);
}

// Row `row`'s entry (it must be touched).
template <typename T>
__device__ __forceinline__ int find_entry(const ChainCarry<T>& cr, int n_ent,
                                          int row) {
  int i = 0;
  while (i < n_ent - 1 && cr.row[i] != row) ++i;
  return i;
}

// A row's node-space usage of one column: the chain's carry, or in the
// per-eval mode (`kPerEval`, K10) eval e's own base usage, [E, C] at
// `in`, which nothing writes.
template <typename T, bool kPerEval>
__device__ __forceinline__ T usage_at(const T* in, const T* out,
                                      const uint32_t* dirty, size_t col_at,
                                      int row) {
  if (kPerEval) return __ldg(in + col_at + row);
  return carry_at(in, out, dirty, row);
}

// Row `row`'s entry, made from the node-space usage and the eval's base
// collisions at its first touch (one thread).
template <typename T, bool kPerEval = false>
__device__ int entry_for(const Chain<T>& c, const ChainCarry<T>& cr, int e,
                         int row, int& n_ent) {
  if (bit(cr.touched, row)) return find_entry(cr, n_ent, row);
  const int i = n_ent++;
  const size_t col_at = static_cast<size_t>(e) * c.C;
  cr.row[i] = row;
  cr.cpu[i] = usage_at<T, kPerEval>(c.cpu_in, c.cpu_out, cr.dirty, col_at,
                                    row);
  cr.mem[i] = usage_at<T, kPerEval>(c.mem_in, c.mem_out, cr.dirty, col_at,
                                    row);
  cr.disk[i] = usage_at<T, kPerEval>(c.disk_in, c.disk_out, cr.dirty, col_at,
                                     row);
  cr.coll[i] =
      c.coll0 != nullptr ? c.coll0[static_cast<size_t>(e) * c.C + row] : 0;
  set_bit(cr.touched, row);
  return i;
}

// K9's source: a position's score and feasibility from its row, the
// eval's scalars, the row's usage and collisions (its entry's, else the
// carry's, or in the per-eval mode the eval's base usage, and the base
// collisions), the static and the pick's penalty, and the spread state;
// or, where a wide step of an earlier pick of the eval scored it and
// nothing changed it since, from the score cache.
template <typename T, bool kPerEval = false>
struct ChainSource {
  const Chain<T>& c;
  const ChainCarry<T>& cr;
  const int32_t* perm;      // the eval's walk order
  const int32_t* pen_rows;  // the pick's K penalty rows, or null
  T* scores;                // the score cache, by walk position
  int32_t* pos_of;          // a recorded row's walk position
  size_t feas_at;           // the eval's offset into `feasible`
  size_t col_at;            // ... into the [E, C] columns
  T ask_cpu, ask_mem, ask_disk, want;
  int e, n_ent, n_cand;
  bool dh, cache_on, cached;

  __device__ __forceinline__ T usage(const T* in, const T* out,
                                     int row) const {
    return usage_at<T, kPerEval>(in, out, cr.dirty, col_at, row);
  }

  __device__ __forceinline__ bool pick_penalized(int row) const {
    if (pen_rows == nullptr) return false;
    bool hit = false;
    for (int j = 0; j < c.K; ++j) hit |= __ldg(pen_rows + j) == row;
    return hit;
  }

  // The rest of `row` once its cheap test passed: mem and disk fit,
  // distinct_hosts, then the score.
  __device__ __forceinline__ void rest(int row, int ent, T cpu_total, T cpu,
                                       bool pen_row, T& s, bool& f) const {
    const T mem_total = __ldg(c.mem_total + row);
    const T disk_total = __ldg(c.disk_total + row);
    T mem;
    T disk;
    int coll;
    if (ent >= 0) {
      mem = cr.mem[ent];
      disk = cr.disk[ent];
      coll = cr.coll[ent];
    } else {
      mem = usage(c.mem_in, c.mem_out, row);
      disk = usage(c.disk_in, c.disk_out, row);
      coll = c.coll0 != nullptr ? __ldg(c.coll0 + col_at + row) : 0;
    }
    const T cpu_after = cpu + ask_cpu;
    const T mem_after = mem + ask_mem;
    const T disk_after = disk + ask_disk;
    f = (mem_after <= mem_total) & (disk_after <= disk_total) &
        !(dh & (coll > 0));
    if (!f) return;
    const bool pen =
        (c.penalty != nullptr && __ldg(c.penalty + col_at + row) != 0) ||
        pen_row;
    const T aff = c.affinity != nullptr ? __ldg(c.affinity + col_at + row)
                                        : T(0);
    if (c.sp_codes != nullptr) {
      const int32_t* codes =
          c.sp_codes + static_cast<size_t>(e) * c.S * c.C + row;
      const T total = spread_boost(
          c, e, [&](int sl) { return __ldg(codes + static_cast<size_t>(sl) * c.C); });
      s = score_node<T, true>(cpu_total, mem_total, cpu_after, mem_after,
                              coll, pen, aff, total, want, c.spread_fit);
    } else {
      s = score_node<T, false>(cpu_total, mem_total, cpu_after, mem_after,
                               coll, pen, aff, T(0), want, c.spread_fit);
    }
  }

  // the step records its own marks (with pos_of and the scores)
  __device__ __forceinline__ void note(int, int, bool, bool) {}

  template <int W>
  __device__ __forceinline__ void step(const int (&p)[W],
                                       const bool (&valid)[W], int R,
                                       bool record, T (&s)[W], bool (&f)[W]) {
    bool fresh[W];  // scored in this step
    int row[W];
    // the loads in three rounds, as K2's source: a known position's score
    // from the cache, an unknown one's perm entry; the cheap test's
    // columns and the row's entry; the rest of a row that passed it
#pragma unroll
    for (int r = 0; r < W; ++r) {
      const bool known = cached && valid[r] && bit(cr.known, p[r]);
      f[r] = known && bit(cr.feas, p[r]);
      s[r] = f[r] ? scores[p[r]] : T(0);
      fresh[r] = valid[r] && !known;
      row[r] = fresh[r] ? __ldg(perm + p[r]) : 0;
    }
    T cpu_total[W];
    T cpu[W];
    int ent[W];
    bool pen[W];
#pragma unroll
    for (int r = 0; r < W; ++r) {
      if (fresh[r]) {
        f[r] = __ldg(c.feasible + feas_at + row[r]) != 0;
        cpu_total[r] = __ldg(c.cpu_total + row[r]);
        ent[r] = bit(cr.touched, row[r]) ? find_entry(cr, n_ent, row[r]) : -1;
        cpu[r] = ent[r] >= 0 ? cr.cpu[ent[r]]
                             : usage(c.cpu_in, c.cpu_out, row[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < W; ++r) {
      pen[r] = fresh[r] && pick_penalized(row[r]);
      if (fresh[r] && f[r]) {
        f[r] = cpu[r] + ask_cpu <= cpu_total[r];
        if (f[r]) rest(row[r], ent[r], cpu_total[r], cpu[r], pen[r], s[r], f[r]);
      }
    }
    if (record && cache_on) {
      // remember what this step scored, but a penalty row of this pick
#pragma unroll
      for (int r = 0; r < W; ++r) {
        if (r < R) {
          const bool keep = fresh[r] && !pen[r];
          if (keep) {
            // the per-eval mode evicts nothing: no row is looked up
            if (!kPerEval) pos_of[row[r]] = p[r];
            if (f[r]) scores[p[r]] = s[r];
          }
          set_bits(cr.known, __ballot_sync(kFull, keep), p[r], n_cand);
          set_bits(cr.feas, __ballot_sync(kFull, keep && f[r]), p[r], n_cand);
        }
      }
      cached = true;
    }
  }
};

// Clears the cache at row `row` where a step of the eval recorded it
// (its position from pos_of, held only while perm maps it back; one
// thread).
template <typename T>
__device__ __forceinline__ void forget_row(const ChainCarry<T>& cr,
                                           const int32_t* perm,
                                           const int32_t* pos_of, int n_cand,
                                           int row) {
  const int p = pos_of[row];
  if (p >= 0 && p < n_cand && perm[p] == row) {
    clear_bit(cr.known, p);
    clear_bit(cr.feas, p);
  }
}

// One eval of the chain (every thread of the block): its pre-deltas,
// its P picks, the node-space carry rebuilt.  In the per-eval mode
// (`kPerEval`, K10: eval e over its own base usage, nothing chained)
// there are no pre-deltas, evictions or penalty rows and nothing is
// written to node space: only the picks run.
template <typename T, bool kPerEval = false>
__device__ void run_chain_eval(const Chain<T>& c, const ChainCarry<T>& cr,
                               PickShared<T>& sh, T* scores,
                               int32_t* pos_of, int e) {
  const int tid = threadIdx.x;
  const int C = c.C;
  const int n_cand = c.n_cand[e];
  const int32_t* perm = c.perm + static_cast<size_t>(e) * C;
  const int words = (C + 31) >> 5;
  // 1. pre-deltas onto the node-space usage, in row order
  if (!kPerEval && c.pre_rows != nullptr && tid == 0) {
    const size_t b = static_cast<size_t>(e) * c.R;
    for (int r = 0; r < c.R; ++r) {
      add_carry(c, cr, c.pre_rows[b + r], c.pre_cpu[b + r], c.pre_mem[b + r],
                c.pre_disk[b + r]);
    }
  }
  // the eval's entries and score cache start empty
  for (int i = tid; i < 3 * words; i += blockDim.x) cr.touched[i] = 0u;
  if (c.sp_codes != nullptr) {
    const size_t b = static_cast<size_t>(e) * c.S * c.V1;
    for (int i = tid; i < c.S * c.V1; i += blockDim.x) {
      c.prop[i] = c.sp_prop0[b + i];
      c.clr[i] = c.sp_clr0[b + i];
    }
  }
  if (tid == 0) {
    sh.offset = 0;
    sh.dead = 0;
    sh.n_won = 0;
  }
  __syncthreads();

  ChainSource<T, kPerEval> src{c, cr, perm, nullptr, scores, pos_of,
                     static_cast<size_t>(e) * c.feas_es,
                     static_cast<size_t>(e) * C};
  src.e = e;
  src.n_cand = n_cand;
  src.dh = c.distinct_hosts[e] != 0;
  src.cache_on = c.sp_codes == nullptr && c.sc_k == 0;
  src.cached = false;
  const int wanted = c.wanted[e];
  int32_t* rows = c.out_rows + static_cast<size_t>(e) * c.P;
  int32_t* pulls = c.out_pulls + static_cast<size_t>(e) * c.P;
  for (int k = 0; k < c.P; ++k) {
    // uniform across the block: dead was published by the barrier that
    // ended the previous pick
    if (k >= wanted || sh.dead) {
      if (tid == 0) {
        rows[k] = kNoNode;
        pulls[k] = 0;
      }
      continue;
    }
    const size_t ek = static_cast<size_t>(e) * c.P + k;
    const size_t sk = scalar_at(c, e, k);
    if (!kPerEval && tid == 0 && c.evict_rows != nullptr) {
      // 2. the pick's eviction, before it scores
      const int erow = c.evict_rows[ek];
      if (erow >= 0) {
        const int i = entry_for(c, cr, e, erow, sh.n_won);
        cr.cpu[i] = cr.cpu[i] + c.evict_cpu[ek];
        cr.mem[i] = cr.mem[i] + c.evict_mem[ek];
        cr.disk[i] = cr.disk[i] + c.evict_disk[ek];
        cr.coll[i] = cr.coll[i] + c.evict_coll[ek];
        forget_row(cr, perm, pos_of, n_cand, erow);
        if (c.sp_codes != nullptr) spread_bump(c, e, 0, c.clr, erow, -1);
      }
      // the pick's penalty rows are scored afresh (and not recorded)
      for (int j = 0; j < c.K; ++j) {
        const int prow = c.penalty_rows[ek * c.K + j];
        if (prow >= 0) forget_row(cr, perm, pos_of, n_cand, prow);
      }
    }
    __syncthreads();
    if (c.sp_codes != nullptr) spread_slots(c, e, 0);
    // 3. the walk
    src.n_ent = sh.n_won;
    src.pen_rows = !kPerEval && c.evict_rows != nullptr && c.K > 0
                       ? c.penalty_rows + ek * c.K
                       : nullptr;
    src.ask_cpu = c.ask_cpu[sk];
    src.ask_mem = c.ask_mem[sk];
    src.ask_disk = c.ask_disk[sk];
    src.want = static_cast<T>(c.desired[sk]);
    const int offset = sh.offset;
    const WalkEnd<T> walk =
        prefix_walk<T>(src, sh, n_cand, offset, c.limit[sk], n_cand);
    if (tid == 0) {
      // 4. the winner's ask into its entry; a failed pick kills the
      // eval's later picks, as the scheduler coalesces them
      if (walk.win_w >= 0) {
        int p = walk.win_w + offset;
        if (p >= n_cand) p -= n_cand;
        const int row = perm[p];
        rows[k] = row;
        const int i = entry_for<T, kPerEval>(c, cr, e, row, sh.n_won);
        cr.cpu[i] = cr.cpu[i] + c.ask_cpu[sk];
        cr.mem[i] = cr.mem[i] + c.ask_mem[sk];
        cr.disk[i] = cr.disk[i] + c.ask_disk[sk];
        cr.coll[i] = cr.coll[i] + 1;
        clear_bit(cr.known, p);
        clear_bit(cr.feas, p);
        if (c.sp_codes != nullptr) spread_bump(c, e, 0, c.prop, row, -1);
      } else {
        rows[k] = kNoNode;
        sh.dead = 1;
      }
      pulls[k] = walk.pulls;
      sh.offset = (offset + walk.pulls) % n_cand;
    }
    __syncthreads();
  }
  // 5. the node-space carry in the JAX program's order: asks of the
  // successful picks, then the applied evictions (an active pick pulls
  // at least one position)
  if (kPerEval) return;
  if (tid == 0) {
    for (int k = 0; k < c.P; ++k) {
      if (rows[k] < 0) continue;
      const size_t sk = scalar_at(c, e, k);
      add_carry(c, cr, rows[k], c.ask_cpu[sk], c.ask_mem[sk],
                c.ask_disk[sk]);
    }
    if (c.evict_rows != nullptr) {
      for (int k = 0; k < c.P; ++k) {
        const size_t ek = static_cast<size_t>(e) * c.P + k;
        const int erow = c.evict_rows[ek];
        if (pulls[k] <= 0 || erow < 0) continue;
        add_carry(c, cr, erow, c.evict_cpu[ek], c.evict_mem[ek],
                  c.evict_disk[ek]);
      }
    }
  }
  __syncthreads();
}

template <typename T>
struct ChainLaunch {
  Chain<T> c;
  unsigned char* carry;  // global scratch, or null: dynamic shared memory
  T* scores;             // T [C]: the score cache, by walk position
  int32_t* pos_of;       // int32 [C]: a cached row's walk position
};

// The chain: one block, the evals in order.
template <typename T>
__global__ void __launch_bounds__(kPickThreads)
    chain_prefix_kernel(const ChainLaunch<T> a) {
  extern __shared__ __align__(16) unsigned char carry_smem[];
  __shared__ PickShared<T> sh;
  const ChainCarry<T> cr = bind_chain_carry<T>(
      a.carry != nullptr ? a.carry : carry_smem, a.c.C, a.c.P);
  const int words = (a.c.C + 31) >> 5;
  for (int i = threadIdx.x; i < words; i += blockDim.x) cr.dirty[i] = 0u;
  __syncthreads();
  for (int e = 0; e < a.c.E; ++e) {
    run_chain_eval<T>(a.c, cr, sh, a.scores, a.pos_of, e);
  }
}

}  // namespace nk
