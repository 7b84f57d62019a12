// Shared device code of kernels K2 (plan_picks.cu) and K7
// (batch_picks.cu): one block runs the P sequential picks of one eval
// over permuted-space copies of its columns.
//
// Replaces the pick scan of nomad_tpu/ops/batch.py _run_picks (:347)
// for a single group (T = 1, no spread, deltas, ports or devices), as
// plan_picks_full (:766) and plan_picks (:735) run it.
//
// The prologue (gather_candidates) copies the candidate region of every
// column through `perm` into scratch, so each pick reads contiguous
// memory: walk position w is permuted index (w + offset) mod n_cand, a
// rotation with one wrap (the JAX program's closed-form
// _rotated_prefix, taken as an index map).  Tail positions (>= n_cand)
// are never feasible and never rotate, so they are not walked.  Each
// pick scores the region, runs the shared limited walk (walk.cuh), then
// thread 0 scatters the winner's usage and collision deltas and
// advances the offset; a barrier publishes them to the next pick.
// After the first failed pick the rest are inert (rows -1, pulls 0), as
// in the JAX scan.
#pragma once

#include "walk.cuh"

namespace nk {

// permuted-space static bits
constexpr uint8_t kStaticFeasible = 1;
constexpr uint8_t kPenalty = 2;

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
  // permuted-space columns and carries
  T* cpu_total_p;
  T* mem_total_p;
  T* disk_total_p;
  T* cpu_p;
  T* mem_p;
  T* disk_p;
  T* aff_p;
  T* s_w;
  int32_t* coll_p;
  uint8_t* bits_p;
  uint8_t* f_w;
  int32_t* rows;   // [n_picks]
  int32_t* pulls;  // [n_picks], or null
  T ask_cpu, ask_mem, ask_disk, desired;
  int limit, n_cand, n_picks;
  bool distinct_hosts, spread_fit;
};

// Point the permuted-space columns at one eval's scratch: f holds 8
// columns of T, i one of int32 and b two of bytes, each n_cand long.
template <typename T>
__host__ __device__ inline void bind_scratch(Picks<T>& c, T* f, int32_t* i,
                                             uint8_t* b) {
  const size_t n = static_cast<size_t>(c.n_cand);
  c.cpu_total_p = f;
  c.mem_total_p = f + n;
  c.disk_total_p = f + 2 * n;
  c.cpu_p = f + 3 * n;
  c.mem_p = f + 4 * n;
  c.disk_p = f + 5 * n;
  c.aff_p = f + 6 * n;
  c.s_w = f + 7 * n;
  c.coll_p = i;
  c.bits_p = b;
  c.f_w = b + n;
}

// The prologue: the candidate region of every column, in walk order.
template <typename T>
__device__ void gather_candidates(const Picks<T>& c) {
  for (int p = threadIdx.x; p < c.n_cand; p += blockDim.x) {
    const int row = c.perm[p];
    c.cpu_total_p[p] = c.cpu_total[row];
    c.mem_total_p[p] = c.mem_total[row];
    c.disk_total_p[p] = c.disk_total[row];
    c.cpu_p[p] = c.cpu_used[row];
    c.mem_p[p] = c.mem_used[row];
    c.disk_p[p] = c.disk_used[row];
    c.aff_p[p] = c.affinity != nullptr ? c.affinity[row] : T(0);
    c.coll_p[p] = c.collisions != nullptr ? c.collisions[row] : 0;
    c.bits_p[p] = (c.feasible[row] ? kStaticFeasible : 0) |
                  (c.penalty != nullptr && c.penalty[row] ? kPenalty : 0);
  }
}

// The pick loop over the permuted-space carries: writes rows[k] (and
// pulls[k]) for k in [0, n_picks).
template <typename T>
__device__ void pick_loop(const Picks<T>& c, int* sh_offset, int* sh_dead) {
  const int n_cand = c.n_cand;
  for (int k = 0; k < c.n_picks; ++k) {
    const int offset = *sh_offset;
    auto score_at = [&](int w, T& s, bool& f) {
      int p = w + offset;
      if (p >= n_cand) p -= n_cand;
      const T cpu_after = c.cpu_p[p] + c.ask_cpu;
      const T mem_after = c.mem_p[p] + c.ask_mem;
      const T disk_after = c.disk_p[p] + c.ask_disk;
      const T cpu_total = c.cpu_total_p[p];
      const T mem_total = c.mem_total_p[p];
      const bool fit = (cpu_after <= cpu_total) & (mem_after <= mem_total) &
                       (disk_after <= c.disk_total_p[p]);
      const int coll = c.coll_p[p];
      const uint8_t bits = c.bits_p[p];
      f = ((bits & kStaticFeasible) != 0) & fit &
          !(c.distinct_hosts & (coll > 0));
      s = score_node<T, false>(cpu_total, mem_total, cpu_after, mem_after,
                               coll, (bits & kPenalty) != 0, c.aff_p[p],
                               T(0), c.desired, c.spread_fit);
    };
    const WalkOut<T> r =
        limited_walk<T>(n_cand, c.limit, n_cand, c.s_w, c.f_w, score_at);
    if (threadIdx.x == 0) {
      if (r.any) {
        int p = r.win_w + offset;
        if (p >= n_cand) p -= n_cand;
        c.rows[k] = c.perm[p];
        c.cpu_p[p] = c.cpu_p[p] + c.ask_cpu;
        c.mem_p[p] = c.mem_p[p] + c.ask_mem;
        c.disk_p[p] = c.disk_p[p] + c.ask_disk;
        c.coll_p[p] = c.coll_p[p] + 1;
      } else {
        c.rows[k] = kNoNode;
        *sh_dead = 1;
      }
      if (c.pulls != nullptr) c.pulls[k] = r.pulls;
      *sh_offset = (offset + r.pulls) % n_cand;
    }
    __syncthreads();
    if (*sh_dead) {
      // the scheduler coalesces the group's later placements after its
      // first failure: the remaining picks are inert
      for (int j = k + 1 + threadIdx.x; j < c.n_picks; j += blockDim.x) {
        c.rows[j] = kNoNode;
        if (c.pulls != nullptr) c.pulls[j] = 0;
      }
      return;
    }
  }
}

// One eval in one block: the prologue, then the picks.
template <typename T>
__device__ void run_eval(const Picks<T>& c) {
  __shared__ int sh_offset;
  __shared__ int sh_dead;
  gather_candidates<T>(c);
  if (threadIdx.x == 0) {
    sh_offset = 0;
    sh_dead = 0;
  }
  __syncthreads();
  pick_loop<T>(c, &sh_offset, &sh_dead);
}

}  // namespace nk
