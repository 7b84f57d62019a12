// Kernel K9: the chained planner over per-eval BatchInputs — E evals x
// P picks in one launch, serially equivalent — behind the benchmark's
// kernel-only `kernel-chained` rate; with shared columns it is also the
// chain over one snapshot.
//
// Replaces the JAX programs nomad_tpu/ops/batch.py:801
// chained_plan_picks (its eval scan over per-eval BatchInputs with
// optional SpreadInputs :53, StepDeltas :217, PreDeltas :235 and
// `wanted`) and :1262 chained_plan_picks_shared (the same chain over one
// [C] feasibility column; collisions, penalty and affinity zero;
// wanted = desired_count; distinct_hosts off).  Plain twins:
// nomad_tpu_torch/ops/batch.py chained_plan_picks_twin and
// chained_plan_picks_shared_twin.
//
// Design: K3's chain (chained.cuh chain_kernel, run_eval) with one group
// (G = 1) and no ports, devices or group-level options.  Each per-eval
// column is addressed by an eval stride: feasibility [E, C] (stride C)
// or one shared [C] (stride 0); collisions, penalty and affinity
// [E, C] or null (zero).  The per-eval scalars (asks, count, limit) are
// [E] and every pick of an eval reads its eval's.  The static penalty
// column and the pick's penalty rows both apply.  Only eval 0's base
// usage starts the chain (the JAX program reads base_*_used[0]); the
// wrapper passes that row as the carry-in.
//
// What bounds it on an H100: as K3, one SM runs a serial chain of three
// barriered passes per pick over the candidate region; it is bound by
// that chain's latency, not by bandwidth.
//
// Launch: one block of 1,024 threads on the caller's stream; scratch
// and the carry-out come from the wrapper; nothing is synchronised.

#include "chained.cuh"

// Mirrored field for field by the ctypes Structure in ops/_cuda.py.
// A null pointer marks an absent option.
struct ChainedBatchArgs {
  const void* cpu_total;  // T [C]
  const void* mem_total;
  const void* disk_total;
  const void* cpu_in;  // T [C]: eval 0's base usage
  const void* mem_in;
  const void* disk_in;
  void* cpu_out;  // T [C] usage carry-out
  void* mem_out;
  void* disk_out;
  const void* feasible;        // uint8 [E, C], or [C] when feas_shared
  const void* perm;            // int32 [E, C]
  const void* ask_cpu;         // T [E]
  const void* ask_mem;         // T [E]
  const void* ask_disk;        // T [E]
  const void* desired;         // int32 [E]
  const void* limit;           // int32 [E]
  const void* distinct_hosts;  // uint8 [E]
  const void* n_cand;          // int32 [E]
  const void* wanted;          // int32 [E]
  const void* collisions;      // int32 [E, C] or null
  const void* penalty;         // uint8 [E, C] or null
  const void* affinity;        // T [E, C] or null
  const void* sp_codes;        // int32 [E, S, C] or null (no spread)
  const void* sp_desired;      // T [E, S, V1]
  const void* sp_used0;        // T [E, S, V1]
  const void* sp_prop0;        // T [E, S, V1]
  const void* sp_clr0;         // T [E, S, V1]
  const void* sp_weight;       // T [E, S]
  const void* sp_active;       // uint8 [E, S]
  const void* sp_even;         // uint8 [E, S] or null
  const void* sp_group;        // int32 [E, S] or null
  const void* evict_rows;      // int32 [E, P] or null (no step deltas)
  const void* evict_cpu;       // T [E, P]
  const void* evict_mem;
  const void* evict_disk;
  const void* evict_coll;    // int32 [E, P]
  const void* penalty_rows;  // int32 [E, P, K]
  const void* pre_rows;      // int32 [E, R] or null (no pre-deltas)
  const void* pre_cpu;       // T [E, R]
  const void* pre_mem;
  const void* pre_disk;
  void* f_scratch;           // T [9 * C]
  void* i_scratch;           // int32 [(3 + S) * C + 1]
  void* b_scratch;           // uint8 [3 * C]
  void* s_scratch;           // T [3 * S * V1 + 4 * S + 1]
  void* out_rows;            // int32 [E, P]
  void* out_pulls;           // int32 [E, P]
  int E;
  int P;
  int C;
  int S;
  int V1;
  int K;
  int R;
  int feas_shared;
  int spread_fit;
  int is_f64;
  int device;
};

namespace {

template <typename T>
nk::Chain<T> typed(const ChainedBatchArgs& a) {
  nk::Chain<T> c = nk::empty_chain<T>();
  c.cpu_total = static_cast<const T*>(a.cpu_total);
  c.mem_total = static_cast<const T*>(a.mem_total);
  c.disk_total = static_cast<const T*>(a.disk_total);
  c.cpu_in = static_cast<const T*>(a.cpu_in);
  c.mem_in = static_cast<const T*>(a.mem_in);
  c.disk_in = static_cast<const T*>(a.disk_in);
  c.cpu_out = static_cast<T*>(a.cpu_out);
  c.mem_out = static_cast<T*>(a.mem_out);
  c.disk_out = static_cast<T*>(a.disk_out);
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
  c.evict_rows = static_cast<const int32_t*>(a.evict_rows);
  c.evict_cpu = static_cast<const T*>(a.evict_cpu);
  c.evict_mem = static_cast<const T*>(a.evict_mem);
  c.evict_disk = static_cast<const T*>(a.evict_disk);
  c.evict_coll = static_cast<const int32_t*>(a.evict_coll);
  c.penalty_rows = static_cast<const int32_t*>(a.penalty_rows);
  c.pre_rows = static_cast<const int32_t*>(a.pre_rows);
  c.pre_cpu = static_cast<const T*>(a.pre_cpu);
  c.pre_mem = static_cast<const T*>(a.pre_mem);
  c.pre_disk = static_cast<const T*>(a.pre_disk);
  c.E = a.E;
  c.P = a.P;
  c.G = 1;
  c.C = a.C;
  c.S = a.S;
  c.V1 = a.V1;
  c.K = a.K;
  c.R = a.R;
  c.spread_fit = a.spread_fit != 0;
  c.feas_es = a.feas_shared ? 0 : static_cast<size_t>(a.C);
  c.sc_e = 1;  // [E] scalars: every pick reads its eval's
  c.sc_k = 0;
  nk::bind_scratch<T>(c, static_cast<T*>(a.f_scratch),
                      static_cast<int32_t*>(a.i_scratch),
                      static_cast<uint8_t*>(a.b_scratch),
                      static_cast<T*>(a.s_scratch));
  c.out_rows = static_cast<int32_t*>(a.out_rows);
  c.out_pulls = static_cast<int32_t*>(a.out_pulls);
  return c;
}

}  // namespace

extern "C" int nk_chained_batch(const ChainedBatchArgs* a, void* stream) {
  cudaError_t err = cudaSetDevice(a->device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->is_f64) {
    nk::chain_kernel<double><<<1, nk::kThreads, 0, s>>>(typed<double>(*a));
  } else {
    nk::chain_kernel<float><<<1, nk::kThreads, 0, s>>>(typed<float>(*a));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
