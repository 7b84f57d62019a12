// Kernel K1: one select — score every node, then the shuffled limited
// walk — for the CUDA stack's count-1 selects and look-ahead misses.
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
// instantiation.  Such a select walks every candidate (limit
// INT32_MAX), so it reads all C walk positions and two more columns.
//
// What bounds it on an H100: at C = 16,384 in f64 it reads about 1.4 MB
// (eight f64 columns, two byte masks, two int32 columns), about 0.4 us
// at 3.35 TB/s, and does O(C) scalar work (two double pows per node).
// So it is bound by launch latency and by running on one SM: the walk
// needs walk-order prefix counts and a first-emitted argmax, which one
// block of 1,024 threads gets from block scans and one block reduction
// with no cross-block pass.  The single block gives up the other 131
// SMs' bandwidth and the overlap a grid of blocks would have; a
// multi-block version with a decoupled look-back scan is later work.
//
// Launch: one block of 1,024 threads on the caller's stream; nothing
// is allocated here (the wrapper passes C-long scratch) and nothing is
// synchronised.

#include "walk.cuh"

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
  void* s_scratch;         // T [C]
  void* f_scratch;         // uint8 [C]
  void* out_i;             // int32 [3]: row, pulls, feasible_count
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
  T* s_scratch;
  uint8_t* f_scratch;
  int32_t* out_i;
  T* out_best;
  T ask_cpu, ask_mem, ask_disk, desired, has_tput;
  int limit, n_candidates, C;
  bool spread_fit;
};

template <typename T, bool kPolicy>
__global__ void __launch_bounds__(nk::kThreads)
    score_select_kernel(const Cols<T> c) {
  auto score_at = [&](int w, T& s, bool& f) {
    const int row = c.perm[w];
    const T cpu_after = c.cpu_used[row] + c.ask_cpu;
    const T mem_after = c.mem_used[row] + c.ask_mem;
    const T disk_after = c.disk_used[row] + c.ask_disk;
    const T cpu_total = c.cpu_total[row];
    const T mem_total = c.mem_total[row];
    const bool fit = (cpu_after <= cpu_total) & (mem_after <= mem_total) &
                     (disk_after <= c.disk_total[row]);
    f = (c.feasible[row] != 0) & fit;
    nk::PolicyNode<T> pol;
    if (kPolicy) {
      pol.tput_on = c.tput_term != nullptr;
      pol.tput = pol.tput_on ? c.tput_term[row] : T(0);
      pol.has_tput = c.has_tput;
      pol.mig_on = c.mig_term != nullptr;
      pol.mig = pol.mig_on ? c.mig_term[row] : T(0);
    }
    s = nk::score_node<T, true, false, kPolicy>(
        cpu_total, mem_total, cpu_after, mem_after, c.collisions[row],
        c.penalty[row] != 0, c.affinity[row], c.spread[row], c.desired,
        c.spread_fit, T(0), false, pol);
  };
  const nk::WalkOut<T> r = nk::limited_walk<T>(
      c.C, c.limit, c.n_candidates, c.s_scratch, c.f_scratch, score_at);
  if (threadIdx.x == 0) {
    c.out_i[0] = r.any ? c.perm[r.win_w] : nk::kNoNode;
    c.out_i[1] = r.pulls;
    c.out_i[2] = r.feasible_count;
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
  c.s_scratch = static_cast<T*>(a.s_scratch);
  c.f_scratch = static_cast<uint8_t*>(a.f_scratch);
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
  return c;
}

}  // namespace

extern "C" int nk_score_select(const ScoreSelectArgs* a, void* stream) {
  cudaError_t err = cudaSetDevice(a->device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool policy = a->tput_term != nullptr || a->mig_term != nullptr;
  if (a->is_f64) {
    if (policy) {
      score_select_kernel<double, true>
          <<<1, nk::kThreads, 0, s>>>(typed<double>(*a));
    } else {
      score_select_kernel<double, false>
          <<<1, nk::kThreads, 0, s>>>(typed<double>(*a));
    }
  } else if (policy) {
    score_select_kernel<float, true>
        <<<1, nk::kThreads, 0, s>>>(typed<float>(*a));
  } else {
    score_select_kernel<float, false>
        <<<1, nk::kThreads, 0, s>>>(typed<float>(*a));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
