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
// (b) The grid, for a select that consumes the region: walk_grid.cuh's
// cooperative launch of blocks of kGridThreads, block b scoring the walk
// positions [b * span, (b + 1) * span), a thread a contiguous run, in the
// same test-then-score order, its flags and scores into the walk scratch;
// per-block summaries that one warp combines, rescanning from the scratch
// the block that holds the limit-th non-diverted position.  K6
// (walk_only.cu) runs the same grid over given scores.
//
// Exactness: both shapes score a position with walk.cuh's score_node,
// every float op in the JAX program's order (-fmad=false, the one fma XLA
// forms written out, 10^x as pow in double rounded through float); the
// walk's bits are picks.cuh's argument (a) and walk_grid.cuh's (b).
//
// The rule (walk_grid.cuh `takes_grid`): (b) iff limit >= n_candidates,
// else (a).  A limit below the candidates lets the walk stop early, and
// the path's count-1 select (limit 14, ~20 of 10,000 positions) takes
// 0.0038 ms on (a) against 0.0117 on (b); a limit of n_candidates or more
// is a whole-region select, every policy-path select among them: 0.0117
// ms on (b) against 0.119 on (a).  A limited walk that runs long (40
// feasible nodes of 10,000 at limit 14: 3,549 positions) takes 0.023 ms
// on (a) and 0.009 on (b), but only the walk itself can tell how long it
// runs, so it stays on (a).  (picks_timing.py, profiled, with copies of
// the port whose rule takes one shape always; PERF.md §6 row 1.)
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

#include "picks.cuh"
#include "walk_grid.cuh"

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
  nk::GridSums<T> sums;  // (b)'s per-block summaries
  int32_t* out_i;
  T* out_best;
  T ask_cpu, ask_mem, ask_disk, desired, has_tput;
  int limit, n_candidates, C;
  bool spread_fit, count;
};

__device__ __forceinline__ uint8_t walk_flag(bool f, bool bad) {
  return f ? static_cast<uint8_t>(nk::kFeasible | (bad ? nk::kBad : 0)) : 0;
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
    feasible += nk::block_sum(mine);
  }
  if (threadIdx.x == 0) {
    c.out_i[0] = r.win_w >= 0 ? c.perm[r.win_w] : nk::kNoNode;
    c.out_i[1] = r.pulls;
    c.out_i[2] = c.count ? feasible : -1;
    c.out_i[3] = r.walked;
    c.out_best[0] = r.best;
  }
}

// (b)'s source: a position scored as (a)'s, its flags and score written
// into the walk scratch, from which the block and the combine reread it.
template <typename T, bool kPolicy>
struct SelectGridSource {
  const Cols<T>& c;

  __device__ __forceinline__ bool score(int w, T& s) const {
    const bool f = select_position<T, kPolicy>(c, __ldg(c.perm + w), s);
    c.f_walk[w] = walk_flag(f, f && s <= T(0));
    if (f) c.s_walk[w] = s;
    return f;
  }
  __device__ __forceinline__ uint8_t flags(int w, bool other) const {
    return other ? __ldcg(c.f_walk + w) : c.f_walk[w];
  }
  __device__ __forceinline__ T score_at(int w, bool other) const {
    return other ? __ldcg(c.s_walk + w) : c.s_walk[w];
  }
};

template <typename T, bool kPolicy>
__global__ void __launch_bounds__(nk::kGridThreads)
    select_grid_kernel(const Cols<T> c) {
  const SelectGridSource<T, kPolicy> src{c};
  nk::GridEnd<T> r;
  if (nk::grid_walk<T>(src, c.sums, c.C, c.limit, c.n_candidates, r)) {
    c.out_i[0] = r.win_w >= 0 ? c.perm[r.win_w] : nk::kNoNode;
    c.out_i[1] = r.pulls;
    c.out_i[2] = r.feasible;
    c.out_i[3] = c.C;
    c.out_best[0] = r.best;
  }
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
  c.sums = nk::bind_sums<T>(a.summary, a.C);
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

template <typename T, bool kPolicy>
cudaError_t launch(const ScoreSelectArgs& a, cudaStream_t s) {
  const Cols<T> c = typed<T>(a);
  if (!nk::takes_grid(a.limit, a.n_candidates)) {
    select_prefix_kernel<T, kPolicy>
        <<<1, nk::kPickThreads, 0, s>>>(c);
    return cudaGetLastError();
  }
  if (a.summary == nullptr) return cudaErrorInvalidValue;
  static int capacity[64] = {0};
  return nk::launch_grid(select_grid_kernel<T, kPolicy>, c, a.C, a.device,
                         capacity, s);
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
  return nk::takes_grid(limit, n_candidates)
             ? nk::summary_bytes(C, static_cast<size_t>(t_size))
             : 0;
}

extern "C" const char* nk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
