// Kernel K10: E independent evals x P picks in one launch, each over its
// own BatchInputs, behind the benchmark's kernel-only `kernel-batch`
// rate.
//
// Replaces the JAX program nomad_tpu/ops/batch.py:1391
// batch_plan_picks, a vmap of plan_picks (:735, the pick scan
// _run_picks :347 with every pick wanted, no step deltas) over per-eval
// BatchInputs and optional per-eval SpreadInputs (:53), with
// n_candidates a scalar or one per eval.  Plain twin:
// nomad_tpu_torch/ops/batch.py batch_plan_picks_twin.
//
// Design: K7's layout (a grid of E blocks of 1,024 threads, one block
// per eval, each on its own slice of the scratch) around K3's eval body
// (chained.cuh run_eval), which has the spread step, the static penalty
// column, collisions, affinity and distinct_hosts.  One group (G = 1);
// the per-eval scalars are [E].  A block reads its eval's base usage in
// place (node space, never written: no pre-deltas, and no chain carry
// is rebuilt), so no block reads another's state and the blocks need no
// ordering; E > 132 runs in waves.
//
// What bounds it on an H100: each block's serial chain of P picks, each
// three barriered passes over n_cand positions with two double pows a
// position, as K7.  The least traffic is the candidate rows of every
// eval's own columns (three usage and three total columns, feasibility,
// collisions, penalty, affinity, perm) and the [E, P] rows.
//
// Launch: E blocks on the caller's stream; scratch comes from the
// wrapper; nothing is synchronised.

#include "chained.cuh"

// Mirrored field for field by the ctypes Structure in ops/_cuda.py.
// A null pointer marks an absent option.
struct BatchPlanArgs {
  const void* cpu_total;       // T [C], shared
  const void* mem_total;
  const void* disk_total;
  const void* cpu_used;        // T [E, C] per-eval base usage
  const void* mem_used;
  const void* disk_used;
  const void* feasible;        // uint8 [E, C]
  const void* perm;            // int32 [E, C]
  const void* ask_cpu;         // T [E]
  const void* ask_mem;         // T [E]
  const void* ask_disk;        // T [E]
  const void* desired;         // int32 [E]
  const void* limit;           // int32 [E]
  const void* distinct_hosts;  // uint8 [E]
  const void* n_cand;          // int32 [E]
  const void* wanted;          // int32 [E]
  const void* collisions;      // int32 [E, C]
  const void* penalty;         // uint8 [E, C]
  const void* affinity;        // T [E, C]
  const void* sp_codes;        // int32 [E, S, C] or null (no spread)
  const void* sp_desired;      // T [E, S, V1]
  const void* sp_used0;        // T [E, S, V1]
  const void* sp_prop0;        // T [E, S, V1]
  const void* sp_clr0;         // T [E, S, V1]
  const void* sp_weight;       // T [E, S]
  const void* sp_active;       // uint8 [E, S]
  const void* sp_even;         // uint8 [E, S] or null
  const void* sp_group;        // int32 [E, S] or null
  void* f_scratch;             // T [E, 9 * C]
  void* i_scratch;             // int32 [E, (3 + S) * C + 1]
  void* b_scratch;             // uint8 [E, 3 * C]
  void* s_scratch;             // T [E, 3 * S * V1 + 4 * S + 1]
  void* out_rows;              // int32 [E, P]
  void* out_pulls;             // int32 [E, P]
  int E;
  int P;
  int C;
  int S;
  int V1;
  int spread_fit;
  int is_f64;
  int device;
};

namespace {

template <typename T>
struct Scratch {
  T* f;
  int32_t* i;
  uint8_t* b;
  T* s;
  size_t f_len, i_len, b_len, s_len;  // per eval
};

template <typename T>
__global__ void __launch_bounds__(nk::kThreads)
    batch_plan_kernel(const nk::Chain<T> shared, const Scratch<T> sc) {
  __shared__ int sh_offset;
  const int e = blockIdx.x;
  const size_t row0 = static_cast<size_t>(e) * shared.C;
  nk::Chain<T> c = shared;
  c.cpu_out = shared.cpu_out + row0;
  c.mem_out = shared.mem_out + row0;
  c.disk_out = shared.disk_out + row0;
  nk::bind_scratch<T>(c, sc.f + e * sc.f_len, sc.i + e * sc.i_len,
                      sc.b + e * sc.b_len, sc.s + e * sc.s_len);
  nk::run_eval<T>(c, e, &sh_offset);
}

template <typename T>
nk::Chain<T> typed(const BatchPlanArgs& a) {
  nk::Chain<T> c = nk::empty_chain<T>();
  c.cpu_total = static_cast<const T*>(a.cpu_total);
  c.mem_total = static_cast<const T*>(a.mem_total);
  c.disk_total = static_cast<const T*>(a.disk_total);
  // read only: run_eval writes the node-space usage for pre-deltas and
  // the chain carry, and K10 has neither
  c.cpu_out = const_cast<T*>(static_cast<const T*>(a.cpu_used));
  c.mem_out = const_cast<T*>(static_cast<const T*>(a.mem_used));
  c.disk_out = const_cast<T*>(static_cast<const T*>(a.disk_used));
  c.feasible = static_cast<const uint8_t*>(a.feasible);
  c.perm = static_cast<const int32_t*>(a.perm);
  c.ask_cpu = static_cast<const T*>(a.ask_cpu);
  c.ask_mem = static_cast<const T*>(a.ask_mem);
  c.ask_disk = static_cast<const T*>(a.ask_disk);
  c.desired = static_cast<const int32_t*>(a.desired);
  c.limit = static_cast<const int32_t*>(a.limit);
  c.distinct_hosts = static_cast<const uint8_t*>(a.distinct_hosts);
  c.n_cand = static_cast<const int32_t*>(a.n_cand);
  c.wanted = static_cast<const int32_t*>(a.wanted);
  c.coll0 = static_cast<const int32_t*>(a.collisions);
  c.penalty = static_cast<const uint8_t*>(a.penalty);
  c.affinity = static_cast<const T*>(a.affinity);
  c.sp_codes = static_cast<const int32_t*>(a.sp_codes);
  c.sp_desired = static_cast<const T*>(a.sp_desired);
  c.sp_used0 = static_cast<const T*>(a.sp_used0);
  c.sp_prop0 = static_cast<const T*>(a.sp_prop0);
  c.sp_clr0 = static_cast<const T*>(a.sp_clr0);
  c.sp_weight = static_cast<const T*>(a.sp_weight);
  c.sp_active = static_cast<const uint8_t*>(a.sp_active);
  c.sp_even = static_cast<const uint8_t*>(a.sp_even);
  c.sp_group = static_cast<const int32_t*>(a.sp_group);
  c.E = a.E;
  c.P = a.P;
  c.G = 1;
  c.C = a.C;
  c.S = a.S;
  c.V1 = a.V1;
  c.spread_fit = a.spread_fit != 0;
  c.feas_es = static_cast<size_t>(a.C);
  c.sc_e = 1;  // [E] scalars: every pick reads its eval's
  c.sc_k = 0;
  c.chain = false;
  c.out_rows = static_cast<int32_t*>(a.out_rows);
  c.out_pulls = static_cast<int32_t*>(a.out_pulls);
  return c;
}

template <typename T>
Scratch<T> scratch(const BatchPlanArgs& a, const nk::Chain<T>& c) {
  Scratch<T> s;
  s.f = static_cast<T*>(a.f_scratch);
  s.i = static_cast<int32_t*>(a.i_scratch);
  s.b = static_cast<uint8_t*>(a.b_scratch);
  s.s = static_cast<T*>(a.s_scratch);
  s.f_len = nk::f_scratch_len(c);
  s.i_len = nk::i_scratch_len(c);
  s.b_len = nk::b_scratch_len(c);
  s.s_len = nk::s_scratch_len(c);
  return s;
}

template <typename T>
void launch(const BatchPlanArgs& a, cudaStream_t s) {
  const nk::Chain<T> c = typed<T>(a);
  batch_plan_kernel<T><<<a.E, nk::kThreads, 0, s>>>(c, scratch<T>(a, c));
}

}  // namespace

extern "C" int nk_batch_plan(const BatchPlanArgs* a, void* stream) {
  cudaError_t err = cudaSetDevice(a->device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a->E < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->is_f64) {
    launch<double>(*a, s);
  } else {
    launch<float>(*a, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
