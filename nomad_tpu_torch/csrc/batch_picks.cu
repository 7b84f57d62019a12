// Kernel K7: E independent evals x P picks over one shared snapshot in
// one launch, behind the Go bridge's TPUScheduler.ScoreBatch.
//
// Replaces the JAX program nomad_tpu/ops/batch.py:1331
// batch_plan_picks_shared, a vmap of plan_picks (:735) over the evals'
// walk orders, asks, counts and limits, with the node columns shared and
// collisions, penalty and affinity zero.  Plain twin:
// nomad_tpu_torch/ops/batch.py batch_plan_picks_shared_twin.
//
// Design: a grid of E blocks of 1,024 threads, one block per eval, each
// running K2's pick body (picks.cuh) on its own slice of the scratch:
// the prologue gathers the shared columns through perms[e], then every
// one of the P picks runs (wanted = P, as the JAX plan_picks passes
// wanted=None; the host drops the picks past an eval's count).  No
// block reads another's state, so the blocks need no ordering and
// spread over the SMs; E > 132 runs in waves.  The compiled vmapped
// program keeps `fitness * RN(1/18)` and the add of the anti-affinity
// term in one loop fusion, as plan_picks_full does, so K2's __fma_rn
// carries over; the anti-affinity term divides by the eval's own count.
//
// What bounds it on an H100: each block's serial chain of P picks,
// each three barriered passes over n_cand positions with two double
// pows a position, as K2.  The least traffic is the candidate rows of
// six columns and the feasibility byte, the first n_cand entries of
// every perm and the [E, P] rows (~3.3 MB at E = 64, n_cand = 10,000,
// f64: ~1 us at 3.35 TB/s).  The scratch, 8 T + 4 + 2 bytes per
// candidate and eval (~45 MB at that shape in f64), no longer sits in
// L2 as K2's 1.2 MB does, so the picks re-read it from device memory.
//
// Launch: E blocks on the caller's stream; scratch comes from the
// wrapper; nothing is synchronised.

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
  void* f_scratch;         // T [E, 8, n_cand]
  void* i_scratch;         // int32 [E, n_cand]
  void* b_scratch;         // uint8 [E, 2, n_cand]
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
  T* f_scratch;
  int32_t* i_scratch;
  uint8_t* b_scratch;
  int32_t* out;
  int C;
};

template <typename T>
__global__ void __launch_bounds__(nk::kThreads)
    batch_picks_kernel(const Batch<T> b) {
  const int e = blockIdx.x;
  const size_t n = static_cast<size_t>(b.shared.n_cand);
  Picks<T> c = b.shared;
  c.perm = b.perms + static_cast<size_t>(e) * b.C;
  c.ask_cpu = b.ask_cpu[e];
  c.ask_mem = b.ask_mem[e];
  c.ask_disk = b.ask_disk[e];
  c.desired = static_cast<T>(b.desired[e]);
  c.limit = b.limit[e];
  c.rows = b.out + static_cast<size_t>(e) * c.n_picks;
  c.pulls = nullptr;
  nk::bind_scratch<T>(c, b.f_scratch + e * 8 * n, b.i_scratch + e * n,
                      b.b_scratch + e * 2 * n);
  nk::run_eval<T>(c);
}

template <typename T>
Batch<T> typed(const BatchPicksArgs& a) {
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
  b.f_scratch = static_cast<T*>(a.f_scratch);
  b.i_scratch = static_cast<int32_t*>(a.i_scratch);
  b.b_scratch = static_cast<uint8_t*>(a.b_scratch);
  b.out = static_cast<int32_t*>(a.out);
  b.C = a.C;
  return b;
}

}  // namespace

extern "C" int nk_batch_picks(const BatchPicksArgs* a, void* stream) {
  cudaError_t err = cudaSetDevice(a->device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a->E < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->is_f64) {
    batch_picks_kernel<double>
        <<<a->E, nk::kThreads, 0, s>>>(typed<double>(*a));
  } else {
    batch_picks_kernel<float>
        <<<a->E, nk::kThreads, 0, s>>>(typed<float>(*a));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
