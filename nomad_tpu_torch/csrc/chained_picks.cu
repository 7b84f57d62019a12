// Kernel K3: the chained planner — E evals x P picks in one launch,
// serially equivalent — behind the batch worker's prescore pipeline.
//
// Replaces the JAX program nomad_tpu/ops/batch.py:905
// chained_plan_picks_cols (its eval scan :1044, the pick step _run_picks
// :347, _walk :281, _rotated_prefix :268, spread_contribution :155, and
// ops/score.py:69 _pow10).  Plain twin: nomad_tpu_torch/ops/batch.py
// chained_picks_twin (per eval: _run_picks, spread_contribution).
//
// Design: one cooperative grid over the whole card runs the chain
// (chained_grid.cuh chain_grid_kernel; the arithmetic is chained.cuh's,
// which K9 and K10 run in one block).  The usage carry (cpu, mem,
// disk), the static-port occupancy and the free device instances live
// in NODE space in the carry-out tensors, which the prologue copies from
// the carry-in.  Per eval: the pre-deltas (one thread), the gather of
// the candidate region into permuted space (the grid), the P picks with
// each walk's three passes split over the blocks and four grid barriers
// a pick, then the node-space carry rebuilt in the JAX program's order
// (one thread; see chained.cuh).
//
// What bounds it on an H100: a serial chain of picks, each a scoring
// pass over ~10,000 candidates (~120 flops each) and two counting
// passes, joined by grid barriers; per pick it reads the candidate
// region of about ten columns (~1.3 MB at 10,000 candidates in f64) from
// L2.  The design spreads the passes over every SM (the one-block chain
// ran them on one SM of 132); what is left is the barriers' latency and
// block 0's serial steps.
//
// Launch: one cooperative launch on the caller's stream, as many
// 1,024-thread blocks as the card holds at once (the occupancy API) or a
// private cap; scratch comes from the wrapper; nothing is synchronised.
// A grid the card cannot hold fails the launch
// (cudaErrorCooperativeLaunchTooLarge), which the wrapper raises.

#include "chained_grid.cuh"

// Mirrored field for field by the ctypes Structure in ops/_cuda.py.
// A null pointer marks an absent option.
struct ChainedPicksArgs {
  const void* cpu_total;  // T [C]
  const void* mem_total;
  const void* disk_total;
  const void* cpu_in;  // T [C] usage carry-in
  const void* mem_in;
  const void* disk_in;
  void* cpu_out;  // T [C] usage carry-out
  void* mem_out;
  void* disk_out;
  const void* feasible;        // uint8 [E, G, C]
  const void* perm;            // int32 [E, C]
  const void* ask_cpu;         // T [E, P]
  const void* ask_mem;         // T [E, P]
  const void* ask_disk;        // T [E, P]
  const void* desired;         // int32 [E, P]
  const void* limit;           // int32 [E, P]
  const void* distinct_hosts;  // uint8 [E]
  const void* tg_idx;          // int32 [E, P]
  const void* n_cand;          // int32 [E]
  const void* wanted;          // int32 [E]
  const void* coll0;           // int32 [E, G, C] or null
  const void* affinity;        // T [E, G, C] or null
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
  const void* port_ask;    // uint8 [E, G, Q] or null (no ports)
  const void* ports_in;    // uint8 [Q, C]
  void* ports_out;         // uint8 [Q, C]
  const void* dev_ask;     // int32 [E, G, D] or null (no devices)
  const void* devs_in;     // int32 [D, C]
  void* devs_out;          // int32 [D, C]
  const void* dev_aff;     // T [E, G, C] or null
  const void* dev_aff_on;  // uint8 [E, G]
  const void* occ0;        // int32 [E, C] or null
  const void* dh_tg;       // uint8 [E, G] or null
  void* f_scratch;         // T [(7 + 2G) * C]
  void* i_scratch;         // int32 [(2 + G + S + D) * C + G]
  void* b_scratch;         // uint8 [(2 + G + Q) * C]
  void* s_scratch;         // T [3 * S * V1 + 4 * S + 1]
  void* out_rows;          // int32 [E, P]
  void* out_pulls;         // int32 [E, P]
  void* gi_scratch;        // int32 [nk::grid_i_len()]
  void* gf_scratch;        // T [nk::kMaxGridBlocks]
  int E;
  int P;
  int G;
  int C;
  int S;
  int V1;
  int K;
  int R;
  int Q;
  int D;
  int spread_fit;
  int is_f64;
  int device;
  int max_blocks;  // 0: as many blocks as the card holds at once
  int blocks;      // out: the grid launched
};

namespace {

template <typename T>
nk::Chain<T> typed(const ChainedPicksArgs& a) {
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
  c.tg_idx = static_cast<const int32_t*>(a.tg_idx);
  c.n_cand = static_cast<const int32_t*>(a.n_cand);
  c.wanted = static_cast<const int32_t*>(a.wanted);
  c.coll0 = static_cast<const int32_t*>(a.coll0);
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
  c.port_ask = static_cast<const uint8_t*>(a.port_ask);
  c.ports_in = static_cast<const uint8_t*>(a.ports_in);
  c.ports_out = static_cast<uint8_t*>(a.ports_out);
  c.dev_ask = static_cast<const int32_t*>(a.dev_ask);
  c.devs_in = static_cast<const int32_t*>(a.devs_in);
  c.devs_out = static_cast<int32_t*>(a.devs_out);
  c.dev_aff = static_cast<const T*>(a.dev_aff);
  c.dev_aff_on = static_cast<const uint8_t*>(a.dev_aff_on);
  c.occ0 = static_cast<const int32_t*>(a.occ0);
  c.dh_tg = static_cast<const uint8_t*>(a.dh_tg);
  c.E = a.E;
  c.P = a.P;
  c.G = a.G;
  c.C = a.C;
  c.S = a.S;
  c.V1 = a.V1;
  c.K = a.K;
  c.R = a.R;
  c.Q = a.Q;
  c.D = a.D;
  c.spread_fit = a.spread_fit != 0;
  c.feas_es = static_cast<size_t>(a.G) * a.C;  // [E, G, C]
  c.sc_e = a.P;                                // [E, P] per-pick scalars
  nk::bind_scratch<T>(c, static_cast<T*>(a.f_scratch),
                      static_cast<int32_t*>(a.i_scratch),
                      static_cast<uint8_t*>(a.b_scratch),
                      static_cast<T*>(a.s_scratch));
  c.out_rows = static_cast<int32_t*>(a.out_rows);
  c.out_pulls = static_cast<int32_t*>(a.out_pulls);
  return c;
}

template <typename T>
cudaError_t launch(ChainedPicksArgs& a, cudaStream_t s) {
  const nk::Chain<T> c = typed<T>(a);
  const nk::GridScratch<T> g = nk::bind_grid<T>(
      static_cast<int32_t*>(a.gi_scratch), static_cast<T*>(a.gf_scratch));
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, nk::chain_grid_kernel<T>, nk::kThreads, 0);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                               a.device);
  if (err != cudaSuccess) return err;
  const int blocks = a.max_blocks > 0 ? a.max_blocks : per_sm * sms;
  if (blocks < 1) return cudaErrorCooperativeLaunchTooLarge;
  if (blocks > nk::kMaxGridBlocks) return cudaErrorInvalidValue;
  a.blocks = blocks;
  void* kargs[] = {const_cast<nk::Chain<T>*>(&c),
                   const_cast<nk::GridScratch<T>*>(&g)};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(nk::chain_grid_kernel<T>), dim3(blocks),
      dim3(nk::kThreads), kargs, 0, s);
  // a refused launch also sets the runtime's last error: clear it, or
  // the next launch's check would report it again
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

}  // namespace

extern "C" int nk_chained_picks(ChainedPicksArgs* a, void* stream) {
  if (a->G < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(a->device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = a->is_f64 ? launch<double>(*a, s) : launch<float>(*a, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The int32 elements of the grid scratch (the per-block records).
extern "C" int nk_chained_grid_ints() { return nk::grid_i_len(); }

// The per-block records' capacity, the largest grid.
extern "C" int nk_chained_grid_max_blocks() { return nk::kMaxGridBlocks; }

extern "C" const char* nk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
