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
// Design: one block of 256 threads runs the chain (chained_prefix.cuh):
// the evals in order, each pick a prefix walk (picks.cuh) that reads and
// scores only the positions it reaches, in steps of 64 positions
// doubling to 512, and stops after the step holding the limit-th
// non-diverted feasible position.  There is no per-eval prologue: no
// inverse of the walk order and no gather of the candidate region.  A
// position's row comes through perm[e]; its usage is the node-space
// carry (the carry-in, overlaid by the rows the chain has rebuilt so far)
// overlaid by the eval's own entries for the rows its evictions and wins
// touched.  Each per-eval column is addressed by an eval stride:
// feasibility [E, C] (stride C) or one shared [C] (stride 0);
// collisions, penalty and affinity [E, C] or null (zero).  The per-eval
// scalars (asks, count, limit) are [E] and every pick of an eval reads
// its eval's.  The static penalty column and the pick's penalty rows
// both apply.  Only eval 0's base usage starts the chain (the JAX program
// reads base_*_used[0]); the wrapper passes that row as the carry-in.
//
// Exactness: a position's score is K3's (chained.cuh score_position for
// one group); the walk's bits are the prefix argument of picks.cuh (a
// non-diverted position's emit order is its rank among them, a
// diverted one's at least their count, so once `limit` of them are
// walked no later position can win); the entries add in the pick scan's
// order and the carry is rebuilt in the JAX program's (asks, then
// evictions), so both orders of floating-point additions are kept
// (chained_prefix.cuh names the hazards).
//
// What bounds it on an H100: the chain is serial (eval e scores against
// what evals < e left), so it is one SM's latency: a short walk is a step
// or two of a coalesced perm load, dependent row loads from L2, two
// double pows a feasible position, a barrier and a warp scan, and thread
// 0's close; an unlimited walk crosses the whole region in steps of 512
// positions, most of them read back from the score cache after the
// eval's first pick.  The least traffic is the reached rows' columns and
// the [E, P] rows.
//
// Launch: one block of 256 threads on the caller's stream, the carry in
// dynamic shared memory (or the wrapper's global scratch where it does
// not fit); the score cache and its row map, the spread state and the
// carry-out come from the wrapper; nothing is synchronised.

#include "chained_prefix.cuh"

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
  void* carry;               // uint8 [nk_chain_carry_bytes], or null
  void* scores;              // T [C]: the score cache
  void* pos_of;              // int32 [C]: a cached row's position
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
  nk::bind_spread<T>(c, static_cast<T*>(a.s_scratch));
  c.out_rows = static_cast<int32_t*>(a.out_rows);
  c.out_pulls = static_cast<int32_t*>(a.out_pulls);
  return c;
}

template <typename T>
cudaError_t launch(const ChainedBatchArgs& a, cudaStream_t s) {
  nk::ChainLaunch<T> l;
  l.c = typed<T>(a);
  l.carry = static_cast<unsigned char*>(a.carry);
  l.scores = static_cast<T*>(a.scores);
  l.pos_of = static_cast<int32_t*>(a.pos_of);
  const size_t smem =
      l.carry != nullptr ? 0 : nk::chain_carry_bytes(a.C, a.P, sizeof(T));
  return nk::launch_picks(nk::chain_prefix_kernel<T>, 1, smem, s, l);
}

}  // namespace

extern "C" int nk_chained_batch(const ChainedBatchArgs* a, void* stream) {
  cudaError_t err = cudaSetDevice(a->device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = a->is_f64 ? launch<double>(*a, s) : launch<float>(*a, s);
  return static_cast<int>(err);
}

// The chain's carry bytes and the most that lives in shared memory: the
// wrapper sizes its scratch from these.
extern "C" size_t nk_chain_carry_bytes(int C, int P, int t_size) {
  return nk::chain_carry_bytes(C, P, static_cast<size_t>(t_size));
}

extern "C" size_t nk_chain_carry_smem_max() { return nk::kCarrySmemMax; }

extern "C" const char* nk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
