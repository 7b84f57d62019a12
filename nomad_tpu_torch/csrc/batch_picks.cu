// Kernel K7: E independent evals x P picks over one shared snapshot in
// one launch, behind the Go bridge's TPUScheduler.ScoreBatch.
//
// Replaces the JAX program nomad_tpu/ops/batch.py:1331
// batch_plan_picks_shared, a vmap of plan_picks (:735) over the evals'
// walk orders, asks, counts and limits, with the node columns shared and
// collisions, penalty and affinity zero.  Plain twin:
// nomad_tpu_torch/ops/batch.py batch_plan_picks_shared_twin.
//
// Design: a grid of E blocks, one block per eval, each running K2's
// pick body (picks.cuh): every pick a prefix walk over the shared
// columns through perms[e] that reads and scores only the positions it
// reaches, the eval's usage carry a bitmap and a list in the block's
// shared memory (or its slice of the wrapper's scratch), its scores
// cached in the wrapper's scratch.  Every one of
// the P picks runs (wanted = P, as the JAX plan_picks passes
// wanted=None; the host drops the picks past an eval's count).  No block
// reads another's state, so the blocks need no ordering; they are
// narrow (kPickThreads, a few hundred), so several share an SM when E
// exceeds the 132 SMs.  The compiled vmapped program keeps `fitness *
// RN(1/18)` and the add of the anti-affinity term in one loop fusion, as
// plan_picks_full does, so K2's __fma_rn carries over; the anti-affinity
// term divides by the eval's own count.
//
// What bounds it on an H100: each block's serial chain of P picks, each
// a step or two of a coalesced perm load and dependent random row loads,
// two double pows a feasible position and one barrier a step; on long
// walks the random row loads of the cheap test.  The least traffic is the
// reached positions' perm entries and rows of six columns and the
// feasibility byte, the per-eval asks, counts and limits, and the
// [E, P] rows.
//
// Launch: E blocks on the caller's stream; nothing is synchronised.

#include "picks.cuh"

// Mirrored field for field by the ctypes Structure in ops/_cuda.py.
struct BatchPicksArgs {
  const void* cpu_total;   // T [C], shared
  const void* mem_total;
  const void* disk_total;
  const void* cpu_used;    // T [C], shared snapshot usage
  const void* mem_used;
  const void* disk_used;
  const void* feasible;    // uint8 [C], shared
  const void* perms;       // int32 [E, C]
  const void* ask_cpu;     // T [E]
  const void* ask_mem;
  const void* ask_disk;
  const void* desired;     // int32 [E]
  const void* limit;       // int32 [E]
  void* carry;             // uint8 [E, carry_bytes], or null: shared memory
  void* scores;            // T [E, n_cand]: the evals' score caches
  void* out;               // int32 [E, n_picks]
  int E;
  int n_cand;
  int C;
  int n_picks;
  int spread_fit;
  int is_f64;
  int device;
};

namespace {

using nk::Picks;

template <typename T>
struct Batch {
  Picks<T> shared;  // the shared columns and shapes; per-eval fields unset
  const int32_t* __restrict__ perms;
  const T* __restrict__ ask_cpu;
  const T* __restrict__ ask_mem;
  const T* __restrict__ ask_disk;
  const int32_t* __restrict__ desired;
  const int32_t* __restrict__ limit;
  unsigned char* carry;  // global scratch, or null
  size_t carry_stride;
  T* scores;
  int32_t* out;
  int C;
};

template <typename T>
__global__ void __launch_bounds__(nk::kPickThreads)
    batch_picks_kernel(const Batch<T> b) {
  extern __shared__ __align__(16) unsigned char carry_smem[];
  const int e = blockIdx.x;
  Picks<T> c = b.shared;
  c.perm = b.perms + static_cast<size_t>(e) * b.C;
  c.ask_cpu = b.ask_cpu[e];
  c.ask_mem = b.ask_mem[e];
  c.ask_disk = b.ask_disk[e];
  c.desired = static_cast<T>(b.desired[e]);
  c.limit = b.limit[e];
  c.rows = b.out + static_cast<size_t>(e) * c.n_picks;
  c.pulls = nullptr;
  c.scores = b.scores + static_cast<size_t>(e) * c.n_cand;
  nk::run_eval<T>(c, b.carry != nullptr ? b.carry + e * b.carry_stride
                                        : carry_smem);
}

template <typename T>
cudaError_t launch(const BatchPicksArgs& a, cudaStream_t s) {
  Batch<T> b;
  Picks<T>& c = b.shared;
  c.cpu_total = static_cast<const T*>(a.cpu_total);
  c.mem_total = static_cast<const T*>(a.mem_total);
  c.disk_total = static_cast<const T*>(a.disk_total);
  c.cpu_used = static_cast<const T*>(a.cpu_used);
  c.mem_used = static_cast<const T*>(a.mem_used);
  c.disk_used = static_cast<const T*>(a.disk_used);
  c.feasible = static_cast<const uint8_t*>(a.feasible);
  c.collisions = nullptr;
  c.penalty = nullptr;
  c.affinity = nullptr;
  c.n_cand = a.n_cand;
  c.n_picks = a.n_picks;
  c.distinct_hosts = false;
  c.spread_fit = a.spread_fit != 0;
  b.perms = static_cast<const int32_t*>(a.perms);
  b.ask_cpu = static_cast<const T*>(a.ask_cpu);
  b.ask_mem = static_cast<const T*>(a.ask_mem);
  b.ask_disk = static_cast<const T*>(a.ask_disk);
  b.desired = static_cast<const int32_t*>(a.desired);
  b.limit = static_cast<const int32_t*>(a.limit);
  b.carry = static_cast<unsigned char*>(a.carry);
  b.carry_stride = nk::carry_bytes(a.n_cand, a.n_picks, sizeof(T));
  b.scores = static_cast<T*>(a.scores);
  b.out = static_cast<int32_t*>(a.out);
  b.C = a.C;
  const size_t smem = b.carry != nullptr ? 0 : b.carry_stride;
  return nk::launch_picks(batch_picks_kernel<T>, a.E, smem, s, b);
}

}  // namespace

extern "C" int nk_batch_picks(const BatchPicksArgs* a, void* stream) {
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
