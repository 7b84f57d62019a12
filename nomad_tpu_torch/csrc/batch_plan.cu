// Kernel K10: E independent evals x P picks in one launch, each over its
// own BatchInputs, behind the benchmark's kernel-only `kernel-batch`
// rate and 12c (`sharded_batch_plan`, an eval row a launch).
//
// Replaces the JAX program nomad_tpu/ops/batch.py:1391
// batch_plan_picks, a vmap of plan_picks (:735, the pick scan
// _run_picks :347 with every pick wanted, no step deltas) over per-eval
// BatchInputs and optional per-eval SpreadInputs (:53), with
// n_candidates a scalar or one per eval.  Plain twin:
// nomad_tpu_torch/ops/batch.py batch_plan_picks_twin.
//
// Design: a grid of E blocks of 256 threads, block e running eval e
// through K9's eval body (chained_prefix.cuh run_chain_eval) in its
// per-eval mode: every pick a prefix walk (picks.cuh) through perm[e]
// that reads and scores only the positions it reaches, in steps of 64
// positions doubling to 512, and stops after the step holding the
// limit-th non-diverted feasible position.  A position's usage is the
// eval's own base (row e of base_*_used, read in place: nothing is
// written to node space, there are no pre-deltas, evictions or penalty
// rows, and no carry is rebuilt) overlaid by the eval's entries for the
// rows its picks won, updated as x = x + ask in pick order.  The static
// penalty column, collisions, affinity and distinct_hosts ([E, C] and
// [E]), spread ([E, S, ...]), `wanted` and a per-eval n_candidates all
// apply; after the first failed pick the rest are inert (rows -1, pulls
// 0).  The score cache (by walk position, off under spread) is as K9's.
// Each block has its own slice of the carry (dynamic shared memory, or
// the wrapper's global scratch where chain_carry_bytes(C, P) does not
// fit), of the score cache and of the spread state, so no block reads
// another's state and the blocks need no ordering: an E beyond what the
// card holds at once runs in waves.
//
// Exactness: as K9's (chained_prefix.cuh): the score is chained.cuh's for
// one group, every float op in the JAX program's order; the walk's bits
// are picks.cuh's argument.
//
// What bounds it on an H100: each block's serial chain of P picks, each
// a step or two of a coalesced perm load and dependent row loads from L2,
// two double pows a feasible position, a barrier and a warp scan, and
// thread 0's close, as K7; an unlimited pick crosses the region in steps
// of 512 positions, read back from the score cache after the eval's
// first pick.  The least traffic is the reached positions' rows of every
// eval's own columns (three usage and three total columns, feasibility,
// collisions, penalty, affinity, perm) and the [E, P] rows.
//
// Launch: E blocks on the caller's stream; the carry in dynamic shared
// memory or the wrapper's scratch, the score caches and the spread state
// from the wrapper; nothing is synchronised.

#include "chained_prefix.cuh"

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
  void* carry;      // uint8 [E, nk_plan_carry_bytes], or null: shared memory
  void* scores;     // T [E, C]: the evals' score caches (null with spread)
  void* s_scratch;  // T [E, 3 * S * V1 + 4 * S + 1]: spread state, or null
  void* out_rows;   // int32 [E, P]
  void* out_pulls;  // int32 [E, P]
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
struct PlanLaunch {
  nk::Chain<T> c;        // the shared columns and shapes
  unsigned char* carry;  // [E, carry_stride] global scratch, or null
  size_t carry_stride;
  T* scores;             // [E, C], or null (spread: no score cache)
  T* spread;             // [E, spread_stride], or null (no spread)
  size_t spread_stride;
};

template <typename T>
__global__ void __launch_bounds__(nk::kPickThreads)
    batch_plan_kernel(const PlanLaunch<T> a) {
  extern __shared__ __align__(16) unsigned char carry_smem[];
  __shared__ nk::PickShared<T> sh;
  const int e = blockIdx.x;
  nk::Chain<T> c = a.c;
  if (a.spread != nullptr) {
    nk::bind_spread<T>(c, a.spread + e * a.spread_stride);
  }
  const nk::ChainCarry<T> cr = nk::bind_chain_carry<T>(
      a.carry != nullptr ? a.carry + e * a.carry_stride : carry_smem, c.C,
      c.P);
  T* scores =
      a.scores != nullptr ? a.scores + static_cast<size_t>(e) * c.C : nullptr;
  nk::run_chain_eval<T, true>(c, cr, sh, scores, nullptr, e);
}

template <typename T>
nk::Chain<T> typed(const BatchPlanArgs& a) {
  nk::Chain<T> c = nk::empty_chain<T>();
  c.cpu_total = static_cast<const T*>(a.cpu_total);
  c.mem_total = static_cast<const T*>(a.mem_total);
  c.disk_total = static_cast<const T*>(a.disk_total);
  // the evals' own base usage, [E, C], read in place
  c.cpu_in = static_cast<const T*>(a.cpu_used);
  c.mem_in = static_cast<const T*>(a.mem_used);
  c.disk_in = static_cast<const T*>(a.disk_used);
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
cudaError_t launch(const BatchPlanArgs& a, cudaStream_t s) {
  PlanLaunch<T> l;
  l.c = typed<T>(a);
  l.carry = static_cast<unsigned char*>(a.carry);
  l.carry_stride = nk::chain_carry_bytes(a.C, a.P, sizeof(T));
  l.scores = static_cast<T*>(a.scores);
  l.spread = static_cast<T*>(a.s_scratch);
  l.spread_stride = nk::s_scratch_len(l.c);
  if (l.c.sp_codes != nullptr && l.spread == nullptr) {
    return cudaErrorInvalidValue;
  }
  if (l.c.sp_codes == nullptr && l.scores == nullptr) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = l.carry != nullptr ? 0 : l.carry_stride;
  return nk::launch_picks(batch_plan_kernel<T>, a.E, smem, s, l);
}

}  // namespace

extern "C" int nk_batch_plan(const BatchPlanArgs* a, void* stream) {
  cudaError_t err = cudaSetDevice(a->device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a->E < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = a->is_f64 ? launch<double>(*a, s) : launch<float>(*a, s);
  return static_cast<int>(err);
}

// One eval's carry bytes and the most that lives in shared memory: the
// wrapper sizes its scratch from these.
extern "C" size_t nk_plan_carry_bytes(int C, int P, int t_size) {
  return nk::chain_carry_bytes(C, P, static_cast<size_t>(t_size));
}

extern "C" size_t nk_plan_carry_smem_max() { return nk::kCarrySmemMax; }

// The most K10 blocks the card holds at once for a C-row arena and P
// picks (the carry in shared memory where it fits): an E beyond it runs
// in waves.  A negative value is a CUDA error code.
extern "C" int nk_plan_blocks_at_once(int C, int P, int is_f64, int device) {
  cudaError_t err = cudaSetDevice(device);
  const size_t carry = nk::chain_carry_bytes(C, P, is_f64 ? 8 : 4);
  const size_t smem = carry <= nk::kCarrySmemMax ? carry : 0;
  int per_sm = 0;
  if (err == cudaSuccess) {
    err = is_f64 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &per_sm, batch_plan_kernel<double>, nk::kPickThreads,
                       smem)
                 : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &per_sm, batch_plan_kernel<float>, nk::kPickThreads,
                       smem);
  }
  int sms = 0;
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  return err == cudaSuccess ? per_sm * sms : -static_cast<int>(err);
}

extern "C" const char* nk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
