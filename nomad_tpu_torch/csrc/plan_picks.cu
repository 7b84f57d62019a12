// Kernel K2: the look-ahead scan — P sequential picks of one task group
// in one launch — behind the CUDA stack's count > 1 selects.
//
// Replaces the JAX program nomad_tpu/ops/batch.py:766 plan_picks_full
// (via the single-group _run_picks :347, _walk :281, _rotated_prefix
// :268).  Plain twin: nomad_tpu_torch/ops/batch.py run_picks.
//
// Design: one block runs the eval's pick body (picks.cuh, shared with
// K7): each pick is a prefix walk that reads and scores only the
// positions it reaches, in steps that start at kPickFirst positions and
// double up to kPickThreads x kPickWide, and stops after the step
// holding the limit-th non-diverted feasible position; the picks' usage
// carry is a bitmap and a list in shared memory, its scores cached in
// the wrapper's scratch.  There is no prologue.
//
// What bounds it on an H100: on a short walk, the latency of one SM's
// serial chain of P picks, each a coalesced perm load, dependent random
// row loads from L2, two double pows a feasible position, one barrier a
// step and the close; on a long walk (most rows unfit), the random row
// loads of the cheap test, one 32-byte sector each.  The least traffic
// is the reached positions' rows (perm entry, six columns, feasibility,
// collisions, penalty, affinity) and the [2, P] result.  The picks are
// sequential, so the block stays one; a grid barrier (~1.1 us) would
// cost more than a pick's step saves.
//
// Launch: one block on the caller's stream with the carry in dynamic
// shared memory (or the wrapper's scratch); nothing is synchronised.

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
  void* carry;             // uint8 [carry_bytes], or null: shared memory
  void* scores;            // T [n_cand]: the score cache
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
struct Plan {
  Picks<T> c;
  unsigned char* carry;  // global scratch, or null
};

template <typename T>
__global__ void __launch_bounds__(nk::kPickThreads)
    plan_picks_kernel(const Plan<T> p) {
  extern __shared__ __align__(16) unsigned char carry_smem[];
  nk::run_eval<T>(p.c, p.carry != nullptr ? p.carry : carry_smem);
}

template <typename T>
cudaError_t launch(const PlanPicksArgs& a, cudaStream_t s) {
  Plan<T> p;
  Picks<T>& c = p.c;
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
  c.scores = static_cast<T*>(a.scores);
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
  p.carry = static_cast<unsigned char*>(a.carry);
  const size_t smem =
      p.carry != nullptr ? 0 : nk::carry_bytes(a.n_cand, a.n_picks, sizeof(T));
  return nk::launch_picks(plan_picks_kernel<T>, 1, smem, s, p);
}

}  // namespace

extern "C" int nk_plan_picks(const PlanPicksArgs* a, void* stream) {
  cudaError_t err = cudaSetDevice(a->device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = a->is_f64 ? launch<double>(*a, s) : launch<float>(*a, s);
  return static_cast<int>(err);
}

// One eval's carry bytes and the most that lives in shared memory, as
// this library lays them out: the wrapper sizes its scratch from these.
extern "C" size_t nk_pick_carry_bytes(int n_cand, int n_picks, int t_size) {
  return nk::carry_bytes(n_cand, n_picks, static_cast<size_t>(t_size));
}

extern "C" size_t nk_pick_carry_smem_max() { return nk::kCarrySmemMax; }

extern "C" const char* nk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
