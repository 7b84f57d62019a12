// Shared device code of kernel K3 (chained_picks.cu through
// chained_grid.cuh): the P picks of one eval, with every option of the
// JAX pick scan, in steps that the grid chain runs.  K9
// (chained_batch.cu) and K10 (batch_plan.cu) take the argument block, the
// spread state and the score from here and walk through
// chained_prefix.cuh.
//
// Replaces nomad_tpu/ops/batch.py _run_picks (:347) with per-pick group
// routing, spread (spread_contribution :155), step deltas, pre-deltas,
// static ports, device instances, device affinity, a static penalty
// column and distinct_hosts at job and group level, and the walk
// (_walk :281, _rotated_prefix :268).
//
// One eval, as chained_grid.cuh runs it:
//   1. adds its pre-deltas to the node-space usage (one thread, in row
//      order, as XLA's serial scatter adds them; `apply_pre`);
//   2. builds the inverse of its walk order and gathers its candidate
//      region (walk positions < n_cand) through `perm` into
//      permuted-space scratch (`gather_position`);
//   3. runs its P picks: one thread applies the pick's eviction and marks
//      its penalty rows (`open_pick`), the per-slot spread state
//      (combined use map, min and max for even stanzas) is rebuilt
//      (`spread_slots`), the walk scores its positions
//      (`score_position`), and one thread scatters the winner's deltas,
//      advances the offset, records a failed group as dead and clears the
//      penalty rows (`close_pick`);
//   4. (a chain only) rebuilds the node-space carry exactly as the JAX
//      program does (`rebuild_carry`): every successful pick's ask in
//      pick order, then every applied eviction in pick order.  In
//      floating point (u + a1) + a2 and (u + a2) + a1 can differ, so the
//      order is part of the result.
// The per-eval collision columns and spread carries start from that
// eval's inputs; only usage, ports and devices chain across evals.
//
// Layouts.  A per-eval column is addressed as [e * stride + ...]: K3
// passes [E, G, C] feasibility, K9 and K10 [E, C] (G = 1), K9 also one
// shared [C] (stride 0).  The per-pick scalars (asks, count, limit) sit at
// e * sc_e + k * sc_k: [E, P] in K3 (P, 1), [E] in K9 and K10 (1, 0).
// A null `tg_idx` routes every pick to group 0.  The static penalty
// column (K9, K10) and the pick's penalty rows (K3, K9) both apply, as
// `penalty_p | any(perm == penalty_rows[k])` in the JAX step: bit 1 of
// pen_p is the static column, bit 2 the rows of the current pick.
//
// Exactness: as K1/K2 — the score is walk.cuh's score_node (with the
// device-affinity term), every float op in the JAX program's order, each
// rounded on its own (-fmad=false), with the one fma XLA forms
// (fitness * RN(1/18) + anti) written explicitly; 10^x is pow in double
// rounded through float.  score_node adds the spread boost when it is
// non-zero, the JAX program adds it always: the two differ only when
// the sum so far is -0.0, which it never is (every term before it is
// +0.0 or has a sign of its own).  An eviction or penalty row outside the
// candidate region changes only positions the walk never reads, so it
// is applied to the node-space carry alone.
#pragma once

#include <string.h>

#include "walk.cuh"

namespace nk {

constexpr uint8_t kStaticPen = 1;
constexpr uint8_t kRowPen = 2;

template <typename T>
struct Chain {
  const T* __restrict__ cpu_total;
  const T* __restrict__ mem_total;
  const T* __restrict__ disk_total;
  const T* cpu_in;
  const T* mem_in;
  const T* disk_in;
  T* cpu_out;  // node-space usage: the carry (K10: unused, its base in
               // *_in)
  T* mem_out;
  T* disk_out;
  const uint8_t* __restrict__ feasible;
  const int32_t* __restrict__ perm;
  const T* __restrict__ ask_cpu;
  const T* __restrict__ ask_mem;
  const T* __restrict__ ask_disk;
  const int32_t* __restrict__ desired;
  const int32_t* __restrict__ limit;
  const uint8_t* __restrict__ distinct_hosts;
  const int32_t* __restrict__ tg_idx;  // [E, P], or null (group 0)
  const int32_t* __restrict__ n_cand;
  const int32_t* __restrict__ wanted;
  const int32_t* __restrict__ coll0;
  const uint8_t* __restrict__ penalty;  // [E, C] static, or null
  const T* __restrict__ affinity;
  const int32_t* __restrict__ sp_codes;
  const T* __restrict__ sp_desired;
  const T* __restrict__ sp_used0;
  const T* __restrict__ sp_prop0;
  const T* __restrict__ sp_clr0;
  const T* __restrict__ sp_weight;
  const uint8_t* __restrict__ sp_active;
  const uint8_t* __restrict__ sp_even;
  const int32_t* __restrict__ sp_group;
  const int32_t* __restrict__ evict_rows;
  const T* __restrict__ evict_cpu;
  const T* __restrict__ evict_mem;
  const T* __restrict__ evict_disk;
  const int32_t* __restrict__ evict_coll;
  const int32_t* __restrict__ penalty_rows;
  const int32_t* __restrict__ pre_rows;
  const T* __restrict__ pre_cpu;
  const T* __restrict__ pre_mem;
  const T* __restrict__ pre_disk;
  const uint8_t* __restrict__ port_ask;
  const uint8_t* ports_in;
  uint8_t* ports_out;
  const int32_t* __restrict__ dev_ask;
  const int32_t* devs_in;
  int32_t* devs_out;
  const T* __restrict__ dev_aff;
  const uint8_t* __restrict__ dev_aff_on;
  const int32_t* __restrict__ occ0;
  const uint8_t* __restrict__ dh_tg;
  // permuted-space scratch, each column C long (walk positions)
  T* tot_cpu;
  T* tot_mem;
  T* tot_disk;
  T* use_cpu;
  T* use_mem;
  T* use_disk;
  T* s_w;
  T* aff_p;   // [G, C]
  T* daff_p;  // [G, C]
  int32_t* inv;     // node row -> walk position of this eval
  int32_t* dead;    // [G] a group whose pick failed (global: any G)
  int32_t* occ_p;   // pickless-group occupancy
  int32_t* coll_p;  // [G, C]
  int32_t* codes_p;  // [S, C]
  int32_t* devs_p;   // [D, C]
  uint8_t* pen_p;
  uint8_t* f_w;
  uint8_t* feas_p;   // [G, C]
  uint8_t* ports_p;  // [Q, C]
  // spread state of the current eval and pick
  T* prop;    // [S, V1] proposed uses
  T* clr;     // [S, V1] cleared uses
  T* comb;    // [S, V1] combined use map of this pick
  T* sl_min;  // [S] even mode: min over present values
  T* sl_max;  // [S]
  T* sl_has;  // [S] 1 when the use map has a present value
  T* sl_act;  // [S] 1 when the slot scores for this pick's group
  int32_t* out_rows;
  int32_t* out_pulls;
  size_t feas_es;  // eval stride of `feasible` (0: shared)
  int sc_e, sc_k;  // per-pick scalars at e * sc_e + k * sc_k
  int E, P, G, C, S, V1, K, R, Q, D;
  bool spread_fit;
  bool chain;  // rebuild the node-space carry after each eval
};

// Scratch sizes of one eval, in elements: T, int32, bytes, spread T.
template <typename T>
__host__ __device__ inline size_t f_scratch_len(const Chain<T>& c) {
  return static_cast<size_t>(7 + 2 * c.G) * c.C;
}
template <typename T>
__host__ __device__ inline size_t i_scratch_len(const Chain<T>& c) {
  return static_cast<size_t>(2 + c.G + c.S + c.D) * c.C + c.G;
}
template <typename T>
__host__ __device__ inline size_t b_scratch_len(const Chain<T>& c) {
  return static_cast<size_t>(2 + c.G + c.Q) * c.C;
}
template <typename T>
__host__ __device__ inline size_t s_scratch_len(const Chain<T>& c) {
  return 3 * static_cast<size_t>(c.S) * c.V1 + 4 * c.S + 1;
}

// Point the spread state (S and V1 set) at `s`.
template <typename T>
__host__ __device__ inline void bind_spread(Chain<T>& c, T* s) {
  const size_t sv = static_cast<size_t>(c.S) * c.V1;
  c.prop = s;
  c.clr = s + sv;
  c.comb = s + 2 * sv;
  c.sl_min = s + 3 * sv;
  c.sl_max = s + 3 * sv + c.S;
  c.sl_has = s + 3 * sv + 2 * c.S;
  c.sl_act = s + 3 * sv + 3 * c.S;
}

// Point the scratch columns at one eval's slices (the shapes E, G, C,
// S, V1, Q and D set).
template <typename T>
__host__ __device__ inline void bind_scratch(Chain<T>& c, T* f, int32_t* i,
                                             uint8_t* b, T* s) {
  const size_t n = static_cast<size_t>(c.C);
  c.tot_cpu = f;
  c.tot_mem = f + n;
  c.tot_disk = f + 2 * n;
  c.use_cpu = f + 3 * n;
  c.use_mem = f + 4 * n;
  c.use_disk = f + 5 * n;
  c.s_w = f + 6 * n;
  c.aff_p = f + 7 * n;
  c.daff_p = f + (7 + c.G) * n;
  c.inv = i;
  c.occ_p = i + n;
  c.coll_p = i + 2 * n;
  c.codes_p = i + (2 + c.G) * n;
  c.devs_p = i + (2 + c.G + c.S) * n;
  c.dead = i + (2 + c.G + c.S + c.D) * n;
  c.pen_p = b;
  c.f_w = b + n;
  c.feas_p = b + 2 * n;
  c.ports_p = b + (2 + c.G) * n;
  bind_spread<T>(c, s);
}

template <typename T>
__device__ __forceinline__ size_t scalar_at(const Chain<T>& c, int e,
                                            int k) {
  return static_cast<size_t>(e) * c.sc_e + static_cast<size_t>(k) * c.sc_k;
}

template <typename T>
__device__ __forceinline__ int group_of(const Chain<T>& c, int e, int k) {
  return c.tg_idx != nullptr ? c.tg_idx[static_cast<size_t>(e) * c.P + k]
                             : 0;
}

// The spread boost of a node whose stanza s has value slot code_at(s)
// (twin: spread_contribution), the S stanza terms added in order
// starting from zero.
template <typename T, typename CodeAt>
__device__ __forceinline__ T spread_boost(const Chain<T>& c, int e,
                                          CodeAt code_at) {
  const T zero = T(0);
  const T one = T(1);
  T total = zero;
  for (int s = 0; s < c.S; ++s) {
    const int code = code_at(s);
    const T used_node = c.comb[s * c.V1 + code];
    const T dn = c.sp_desired[(static_cast<size_t>(e) * c.S + s) * c.V1 +
                              code];
    const T safe_d = dn != zero ? dn : one;
    const T frac = (dn - (used_node + one)) / safe_d;
    const T pct = frac * c.sp_weight[e * c.S + s];
    const bool pen_node = code == c.V1 - 1;
    T contrib = pen_node ? -one : pct;
    if (c.sp_even != nullptr && c.sp_even[e * c.S + s]) {
      const T mn = c.sl_min[s];
      const T mx = c.sl_max[s];
      const T safe_min = mn > zero ? mn : one;
      const T delta_boost = mn == zero ? -one : (mn - used_node) / safe_min;
      T even_val;
      if (used_node != mn) {
        even_val = delta_boost;
      } else if (mn == mx) {
        even_val = -one;
      } else {
        even_val = mn == zero ? one : (mx - mn) / safe_min;
      }
      contrib = c.sl_has[s] != zero ? (pen_node ? -one : even_val) : zero;
    }
    contrib = c.sl_act[s] != zero ? contrib : zero;
    total = total + contrib;
  }
  return total;
}

// The spread boost of walk position p (its codes in permuted space).
template <typename T>
__device__ __forceinline__ T spread_total(const Chain<T>& c, int e, int p) {
  return spread_boost(c, e, [&](int s) { return c.codes_p[s * c.C + p]; });
}

// Score and feasibility of walk position p for pick k of group t
// (twin: the body of _run_picks).
template <typename T>
__device__ __forceinline__ void score_position(const Chain<T>& c, int e,
                                               int k, int t, int p, T& s,
                                               bool& f) {
  const size_t sk = scalar_at(c, e, k);
  const T cpu_after = c.use_cpu[p] + c.ask_cpu[sk];
  const T mem_after = c.use_mem[p] + c.ask_mem[sk];
  const T disk_after = c.use_disk[p] + c.ask_disk[sk];
  const T cpu_total = c.tot_cpu[p];
  const T mem_total = c.tot_mem[p];
  const bool fit = (cpu_after <= cpu_total) & (mem_after <= mem_total) &
                   (disk_after <= c.tot_disk[p]);
  const int coll = c.coll_p[t * c.C + p];
  int occupancy = 0;
  for (int g = 0; g < c.G; ++g) occupancy += c.coll_p[g * c.C + p];
  if (c.occ0 != nullptr) occupancy += c.occ_p[p];
  bool feasible = c.feas_p[t * c.C + p] != 0 && fit;
  if (c.distinct_hosts[e]) feasible = feasible && !(occupancy > 0);
  if (c.dh_tg != nullptr && c.dh_tg[e * c.G + t]) {
    feasible = feasible && !(coll > 0);
  }
  if (c.port_ask != nullptr) {
    const uint8_t* ask = c.port_ask + (static_cast<size_t>(e) * c.G + t) * c.Q;
    for (int q = 0; q < c.Q; ++q) {
      if (ask[q] && c.ports_p[q * c.C + p]) feasible = false;
    }
  }
  if (c.dev_ask != nullptr) {
    const int32_t* ask = c.dev_ask + (static_cast<size_t>(e) * c.G + t) * c.D;
    for (int d = 0; d < c.D; ++d) {
      if (ask[d] != 0 && c.devs_p[d * c.C + p] < ask[d]) feasible = false;
    }
  }
  f = feasible;

  const T aff = c.aff_p[t * c.C + p];
  const bool pen = c.pen_p[p] != 0;
  const T total = c.sp_codes != nullptr ? spread_total(c, e, p) : T(0);
  const T dev_aff = c.dev_aff != nullptr ? c.daff_p[t * c.C + p] : T(0);
  const bool dev_on = c.dev_aff != nullptr && c.dev_aff_on[e * c.G + t];
  const T want = static_cast<T>(c.desired[sk]);
  // the terms the JAX program appends only when present are selected
  // at compile time, so absent ones add nothing
  if (c.dev_aff != nullptr) {
    s = c.sp_codes != nullptr
            ? score_node<T, true, true>(cpu_total, mem_total, cpu_after,
                                        mem_after, coll, pen, aff, total,
                                        want, c.spread_fit, dev_aff, dev_on)
            : score_node<T, false, true>(cpu_total, mem_total, cpu_after,
                                         mem_after, coll, pen, aff, total,
                                         want, c.spread_fit, dev_aff,
                                         dev_on);
  } else {
    s = c.sp_codes != nullptr
            ? score_node<T, true>(cpu_total, mem_total, cpu_after,
                                  mem_after, coll, pen, aff, total, want,
                                  c.spread_fit)
            : score_node<T, false>(cpu_total, mem_total, cpu_after,
                                   mem_after, coll, pen, aff, total, want,
                                   c.spread_fit);
  }
}

// The per-slot spread state of pick k of group t: the combined use map
// (GetCombinedUseMap with the cleared-decrement quirk), the min and max
// over present values, and which slots score.  Every thread calls it.
template <typename T>
__device__ void spread_slots(const Chain<T>& c, int e, int t) {
  const T zero = T(0);
  const T one = T(1);
  const size_t base = static_cast<size_t>(e) * c.S * c.V1;
  for (int i = threadIdx.x; i < c.S * c.V1; i += blockDim.x) {
    const T prop = c.prop[i];
    const T clr = c.clr[i];
    const T clr_adj = clr - ((prop > zero) && (clr > one) ? one : zero);
    const T x = (c.sp_used0[base + i] + prop) - clr_adj;
    c.comb[i] = x > zero ? x : zero;
  }
  __syncthreads();
  for (int s = threadIdx.x; s < c.S; s += blockDim.x) {
    T mn = static_cast<T>(INFINITY);
    T mx = -static_cast<T>(INFINITY);
    bool has = false;
    for (int v = 0; v < c.V1 - 1; ++v) {
      const int i = s * c.V1 + v;
      if ((c.sp_used0[base + i] + c.prop[i]) > zero) {
        has = true;
        const T x = c.comb[i];
        mn = x < mn ? x : mn;
        mx = x > mx ? x : mx;
      }
    }
    c.sl_min[s] = mn;
    c.sl_max[s] = mx;
    c.sl_has[s] = has ? one : zero;
    const bool act = c.sp_active[e * c.S + s] != 0 &&
                     (c.sp_group == nullptr || c.sp_group[e * c.S + s] == t);
    c.sl_act[s] = act ? one : zero;
  }
  __syncthreads();
}

// One slot set of group t's spread carry gains a use at node `row`
// (codes in node space) or walk position `p` (codes_p).
template <typename T>
__device__ __forceinline__ void spread_bump(const Chain<T>& c, int e, int t,
                                            T* carry, int code_base_row,
                                            int p) {
  for (int s = 0; s < c.S; ++s) {
    if (c.sp_group != nullptr && c.sp_group[e * c.S + s] != t) continue;
    const int code =
        p >= 0 ? c.codes_p[s * c.C + p]
               : c.sp_codes[(static_cast<size_t>(e) * c.S + s) * c.C +
                            code_base_row];
    carry[s * c.V1 + code] = carry[s * c.V1 + code] + T(1);
  }
}

// The eval's serial steps, each on one thread, as the grid chain
// (chained_grid.cuh) runs them.

// 1. The eval's pre-deltas onto the node-space usage, in row order.
template <typename T>
__device__ void apply_pre(const Chain<T>& c, int e) {
  const size_t b = static_cast<size_t>(e) * c.R;
  for (int r = 0; r < c.R; ++r) {
    const int row = c.pre_rows[b + r];
    c.cpu_out[row] = c.cpu_out[row] + c.pre_cpu[b + r];
    c.mem_out[row] = c.mem_out[row] + c.pre_mem[b + r];
    c.disk_out[row] = c.disk_out[row] + c.pre_disk[b + r];
  }
}

// 2. Walk position p of the candidate region into permuted space.
template <typename T>
__device__ __forceinline__ void gather_position(const Chain<T>& c, int e,
                                                const int32_t* perm, int p) {
  const int C = c.C;
  const int row = perm[p];
  c.tot_cpu[p] = c.cpu_total[row];
  c.tot_mem[p] = c.mem_total[row];
  c.tot_disk[p] = c.disk_total[row];
  c.use_cpu[p] = c.cpu_out[row];
  c.use_mem[p] = c.mem_out[row];
  c.use_disk[p] = c.disk_out[row];
  c.pen_p[p] = c.penalty != nullptr &&
                       c.penalty[static_cast<size_t>(e) * C + row]
                   ? kStaticPen
                   : 0;
  c.occ_p[p] = c.occ0 != nullptr ? c.occ0[static_cast<size_t>(e) * C + row]
                                 : 0;
  for (int g = 0; g < c.G; ++g) {
    const size_t src = (static_cast<size_t>(e) * c.G + g) * C + row;
    c.feas_p[g * C + p] = c.feasible[e * c.feas_es + g * C + row];
    c.coll_p[g * C + p] = c.coll0 != nullptr ? c.coll0[src] : 0;
    c.aff_p[g * C + p] = c.affinity != nullptr ? c.affinity[src] : T(0);
    if (c.dev_aff != nullptr) c.daff_p[g * C + p] = c.dev_aff[src];
  }
  for (int s = 0; s < c.S; ++s) {
    c.codes_p[s * C + p] =
        c.sp_codes[(static_cast<size_t>(e) * c.S + s) * C + row];
  }
  for (int q = 0; q < c.Q; ++q) c.ports_p[q * C + p] = c.ports_out[q * C + row];
  for (int d = 0; d < c.D; ++d) c.devs_p[d * C + p] = c.devs_out[d * C + row];
}

// 3a. Pick k of group t opens: its eviction and its penalty rows.
template <typename T>
__device__ void open_pick(const Chain<T>& c, int e, int k, int t,
                          int n_cand) {
  if (c.evict_rows == nullptr) return;
  const int C = c.C;
  const size_t ek = static_cast<size_t>(e) * c.P + k;
  const int erow = c.evict_rows[ek];
  if (erow >= 0) {
    const int epos = c.inv[erow];
    if (epos < n_cand) {
      c.use_cpu[epos] = c.use_cpu[epos] + c.evict_cpu[ek];
      c.use_mem[epos] = c.use_mem[epos] + c.evict_mem[ek];
      c.use_disk[epos] = c.use_disk[epos] + c.evict_disk[ek];
      c.coll_p[t * C + epos] = c.coll_p[t * C + epos] + c.evict_coll[ek];
    }
    if (c.sp_codes != nullptr) spread_bump(c, e, t, c.clr, erow, -1);
  }
  for (int j = 0; j < c.K; ++j) {
    const int prow = c.penalty_rows[ek * c.K + j];
    if (prow >= 0 && c.inv[prow] < n_cand) c.pen_p[c.inv[prow]] |= kRowPen;
  }
}

// 3b. Pick k of group t closes on its walk: the winner's deltas, its row
// and pulls, a failed group marked dead, the penalty rows cleared.
// Returns the next walk offset.
template <typename T>
__device__ int close_pick(const Chain<T>& c, int e, int k, int t, int n_cand,
                          int offset, int any, int win_w, int n_pulls,
                          int32_t* rows, int32_t* pulls) {
  const int C = c.C;
  const size_t ek = static_cast<size_t>(e) * c.P + k;
  const size_t sk = scalar_at(c, e, k);
  const int32_t* perm = c.perm + static_cast<size_t>(e) * C;
  if (any) {
    int p = win_w + offset;
    if (p >= n_cand) p -= n_cand;
    rows[k] = perm[p];
    c.use_cpu[p] = c.use_cpu[p] + c.ask_cpu[sk];
    c.use_mem[p] = c.use_mem[p] + c.ask_mem[sk];
    c.use_disk[p] = c.use_disk[p] + c.ask_disk[sk];
    c.coll_p[t * C + p] = c.coll_p[t * C + p] + 1;
    if (c.port_ask != nullptr) {
      const uint8_t* ask =
          c.port_ask + (static_cast<size_t>(e) * c.G + t) * c.Q;
      for (int q = 0; q < c.Q; ++q) {
        if (ask[q]) c.ports_p[q * C + p] = 1;
      }
    }
    if (c.dev_ask != nullptr) {
      const int32_t* ask =
          c.dev_ask + (static_cast<size_t>(e) * c.G + t) * c.D;
      for (int d = 0; d < c.D; ++d) {
        c.devs_p[d * C + p] = c.devs_p[d * C + p] - ask[d];
      }
    }
    if (c.sp_codes != nullptr) spread_bump(c, e, t, c.prop, 0, p);
  } else {
    // the scheduler coalesces a group's later placements after its
    // first failure: that group's remaining picks are inert
    rows[k] = kNoNode;
    c.dead[t] = 1;
  }
  pulls[k] = n_pulls;
  if (c.evict_rows != nullptr) {
    for (int j = 0; j < c.K; ++j) {
      const int prow = c.penalty_rows[ek * c.K + j];
      if (prow >= 0 && c.inv[prow] < n_cand) {
        c.pen_p[c.inv[prow]] &= kStaticPen;
      }
    }
  }
  return (offset + n_pulls) % n_cand;
}

// 4. The node-space carry, in the JAX program's order: asks of the
// successful picks, then the applied evictions.  An active pick always
// pulls at least one position (n_cand >= 1), so pulls > 0 marks the
// picks whose eviction was applied.
template <typename T>
__device__ void rebuild_carry(const Chain<T>& c, int e, const int32_t* rows,
                              const int32_t* pulls) {
  const int C = c.C;
  for (int k = 0; k < c.P; ++k) {
    const int row = rows[k];
    if (row < 0) continue;
    const size_t sk = scalar_at(c, e, k);
    const int t = group_of(c, e, k);
    c.cpu_out[row] = c.cpu_out[row] + c.ask_cpu[sk];
    c.mem_out[row] = c.mem_out[row] + c.ask_mem[sk];
    c.disk_out[row] = c.disk_out[row] + c.ask_disk[sk];
    if (c.port_ask != nullptr) {
      const uint8_t* ask =
          c.port_ask + (static_cast<size_t>(e) * c.G + t) * c.Q;
      for (int q = 0; q < c.Q; ++q) {
        if (ask[q]) c.ports_out[q * C + row] = 1;
      }
    }
    if (c.dev_ask != nullptr) {
      const int32_t* ask =
          c.dev_ask + (static_cast<size_t>(e) * c.G + t) * c.D;
      for (int d = 0; d < c.D; ++d) {
        c.devs_out[d * C + row] = c.devs_out[d * C + row] - ask[d];
      }
    }
  }
  if (c.evict_rows != nullptr) {
    for (int k = 0; k < c.P; ++k) {
      const size_t ek = static_cast<size_t>(e) * c.P + k;
      const int erow = c.evict_rows[ek];
      if (pulls[k] <= 0 || erow < 0) continue;
      c.cpu_out[erow] = c.cpu_out[erow] + c.evict_cpu[ek];
      c.mem_out[erow] = c.mem_out[erow] + c.evict_mem[ek];
      c.disk_out[erow] = c.disk_out[erow] + c.evict_disk[ek];
    }
  }
}

// Null every option pointer and set the K3 defaults: [E, G, C]
// feasibility, [E, P] per-pick scalars, a chain.
template <typename T>
__host__ inline Chain<T> empty_chain() {
  Chain<T> c;
  memset(&c, 0, sizeof(c));
  c.sc_k = 1;
  c.chain = true;
  return c;
}

}  // namespace nk
