// Kernel K2: the look-ahead scan — P sequential picks of one task group
// in one launch — behind the CUDA stack's count > 1 selects.
//
// Replaces the JAX program nomad_tpu/ops/batch.py:766 plan_picks_full
// (via the single-group _run_picks :347, _walk :281, _rotated_prefix
// :268).  Plain twin: nomad_tpu_torch/ops/batch.py run_picks.
//
// Design: one block of 1,024 threads runs the eval's pick body
// (picks.cuh, shared with K7): a prologue gathers the candidate region
// of every column through `perm` into permuted-space scratch, then the
// picks score, walk (walk.cuh) and scatter one after another.
//
// What bounds it on an H100: per pick it reads about n_cand * (7 * 8 +
// 6) bytes from L2 (~1 MB at 16k candidates in f64) and does two
// double pows per node; with P picks in sequence and three barriered
// passes per pick it is bound by the latency of one SM's serial chain,
// not by bandwidth.  The single block gives up the other SMs; K7
// (batch_picks.cu) runs the same pick body in one block per eval.
//
// Launch: one block on the caller's stream; scratch comes from the
// wrapper; nothing is synchronised.

#include "picks.cuh"

// Mirrored field for field by the ctypes Structure in ops/_cuda.py.
struct PlanPicksArgs {
  const void* cpu_total;
  const void* mem_total;
  const void* disk_total;
  const void* cpu_used;    // base usage, node space
  const void* mem_used;
  const void* disk_used;
  const void* feasible;    // uint8 [C]
  const void* collisions;  // int32 [C]
  const void* penalty;     // uint8 [C]
  const void* affinity;
  const void* perm;        // int32 [C]
  void* f_scratch;         // T [8, n_cand]
  void* i_scratch;         // int32 [n_cand]
  void* b_scratch;         // uint8 [2, n_cand]
  void* out;               // int32 [2, n_picks]: rows; pulls
  double ask_cpu;
  double ask_mem;
  double ask_disk;
  int desired;
  int limit;
  int n_cand;
  int C;
  int n_picks;
  int distinct_hosts;
  int spread_fit;
  int is_f64;
  int device;
};

namespace {

using nk::Picks;

template <typename T>
__global__ void __launch_bounds__(nk::kThreads)
    plan_picks_kernel(const Picks<T> c) {
  nk::run_eval<T>(c);
}

template <typename T>
Picks<T> typed(const PlanPicksArgs& a) {
  Picks<T> c;
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
  c.perm = static_cast<const int32_t*>(a.perm);
  c.rows = static_cast<int32_t*>(a.out);
  c.pulls = c.rows + a.n_picks;
  // host doubles round to T here exactly as the twin's torch.as_tensor
  c.ask_cpu = static_cast<T>(a.ask_cpu);
  c.ask_mem = static_cast<T>(a.ask_mem);
  c.ask_disk = static_cast<T>(a.ask_disk);
  c.desired = static_cast<T>(a.desired);
  c.limit = a.limit;
  c.n_cand = a.n_cand;
  c.n_picks = a.n_picks;
  c.distinct_hosts = a.distinct_hosts != 0;
  c.spread_fit = a.spread_fit != 0;
  nk::bind_scratch<T>(c, static_cast<T*>(a.f_scratch),
                      static_cast<int32_t*>(a.i_scratch),
                      static_cast<uint8_t*>(a.b_scratch));
  return c;
}

}  // namespace

extern "C" int nk_plan_picks(const PlanPicksArgs* a, void* stream) {
  cudaError_t err = cudaSetDevice(a->device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->is_f64) {
    plan_picks_kernel<double><<<1, nk::kThreads, 0, s>>>(typed<double>(*a));
  } else {
    plan_picks_kernel<float><<<1, nk::kThreads, 0, s>>>(typed<float>(*a));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
