// Kernel K5: the global storm assignment — one solve for a backlog of
// A pending-alloc rows of E evals over the C-node arena — behind the
// batch worker's storm path (NOMAD_TPU_STORM=1).
//
// Replaces the JAX program nomad_tpu/ops/solve.py:113 storm_assignment
// (its broadcast _score_vectors with the policy rows :98-107,161-167,
// the vmapped _limited_walk_argmax warm start, and the auction
// lax.while_loop :233-297).  Plain twin: nomad_tpu_torch/ops/solve.py
// storm_assignment_twin.
//
// A weighted storm (a member whose job resolves a PolicySpec) passes
// three more per-eval inputs, pre-scaled on the host: the throughput
// rows [E, C], their counts [E] and the migration rows [E, C].  The
// score pass gathers them by the row's eval, as the JAX program
// gathers [eo]; policy-less evals carry all-zero rows, which add
// nothing (and count nothing) float-exactly.  With the three pointers
// null the score pass is the unweighted instantiation.
//
// Three launches on the caller's stream, no host read between them:
//   1. score (grid over node tiles x rows): feasibility and score of
//      every (row, node) pair into [A, C] scratch, through walk.cuh's
//      score_node with the row's eval slice (policy terms included),
//      the mirror columns plus the staged pre-placement deltas, and
//      the row's `real` flag;
//   2. walk (one block of 1,024 threads per row): K1's limited walk
//      over the row's perm, limit and candidate count — the warm
//      start (rows0, pulls0), which is also the `greedy` output;
//   3. auction (one cooperative launch of 1,024-thread blocks, as many
//      as the card holds at once): the while_loop stays on the card.
//      The mirror's free capacity and zero prices are set, then
//      csrc/storm_round.cuh runs the rounds over the arena as one shard:
//      a round is phase B (each row still bidding scans its nodes, a
//      warp a (row, chunk) item) and phase RD (block 0 ranks, accepts,
//      debits and prices in shared memory over the bidders grouped by
//      node), two grid barriers a round; a row without a bid leaves the
//      bidding for good.  The epilogue writes pulls (the walk's when the
//      greedy pick held, else the row's candidate count), the score of
//      the assignment and the round count.
//   Why a cooperative launch and not a launch per phase: the loop runs
//   up to A rounds (1,024 on the storm path); launches a round, each
//   returning at once when a device flag says the loop is done, would
//   enqueue thousands of launches per solve whatever the rounds run.
// Exactness: as K1-K3 — score_node's float ops in the JAX program's
// order, each rounded on its own (-fmad=false), with the one fma XLA
// forms written explicitly; the jitter is the int32 Knuth-hash lattice
// computed in uint32 (the same low 16 bits) and scaled as the twin
// scales it; max is exact in any order; the debit adds in ascending
// row order, which equals XLA's dot for whole-valued asks.
//
// What bounds it on an H100: the score pass writes the [A, C] matrix
// (128 MiB in f64 at A = 1,024, C = 16,384; a weighted storm reads two
// more [E, C] rows, 256 MiB at E = 1,024) and every auction round's
// phase B re-reads the bidding rows of it, so it is bound by bytes; the
// walk pass is K1's latency-bound walk, one block per row, ~8 rows per
// SM at full width; phase RD is one block's latency, a grid barrier
// ~1.1 us.
//
// Launch: nothing is allocated here (the wrapper passes the scratch)
// and nothing is synchronised.

#include "storm_round.cuh"
#include "walk.cuh"

// Mirrored field for field by the ctypes Structure in ops/_cuda.py.
struct StormArgs {
  const void* cpu_total;   // T [C]
  const void* mem_total;   // T [C]
  const void* disk_total;  // T [C]
  const void* cpu_used;    // T [C] mirror usage
  const void* mem_used;
  const void* disk_used;
  const void* feasible;    // uint8 [E, C]
  const void* affinity;    // T [E, C]
  const void* collisions;  // int32 [E, C]
  const void* perm;        // int32 [E, C]
  const void* limit;       // int32 [E]
  const void* n_cand;      // int32 [E]
  const void* eval_of;     // int32 [A]
  const void* penalty;     // uint8 [A, C]
  const void* ask;         // T [A, 3]
  const void* desired;     // int32 [A]
  const void* real;        // uint8 [A]
  const void* pre_cpu;     // T [C]
  const void* pre_mem;
  const void* pre_disk;
  const void* policy_tput;  // T [E, C] or null (unweighted storm)
  const void* policy_has;   // T [E] or null
  const void* policy_mig;   // T [E, C] or null
  void* scores;    // T [A, C] scratch
  void* feas;      // uint8 [A, C] scratch
  void* s_walk;    // T [A, C] scratch (walk order)
  void* f_walk;    // uint8 [A, C] scratch (walk order)
  void* free_cap;  // T [C, 3] scratch
  void* price;     // T [C] scratch
  void* round;     // storm::scratch_bytes(A, C, 1) bytes of scratch
  void* progress;  // int32 [max(1, max_rounds)] scratch
  void* pulls0;    // int32 [A] scratch
  void* out_assigned;  // int32 [A]
  void* out_pulls;     // int32 [A]
  void* out_round;     // int32 [A]
  void* out_score;     // T [A]
  void* out_greedy;    // int32 [A] (the warm start's rows0)
  void* out_rounds;    // int32 [1]
  void* stamps;        // int64 [5 + 3 * max(1, max_rounds)] or null
  int max_blocks;      // the auction's grid cap (0: as the card holds)
  int blocks;          // out: the auction's grid
  int E;
  int A;
  int C;
  int max_rounds;
  int spread_fit;
  int is_f64;
  int device;
};

namespace {

constexpr int kScoreThreads = 256;
using storm::stamp;

template <typename T>
struct Storm {
  const T* __restrict__ cpu_total;
  const T* __restrict__ mem_total;
  const T* __restrict__ disk_total;
  const T* __restrict__ cpu_used;
  const T* __restrict__ mem_used;
  const T* __restrict__ disk_used;
  const uint8_t* __restrict__ feasible;
  const T* __restrict__ affinity;
  const int32_t* __restrict__ collisions;
  const int32_t* __restrict__ perm;
  const int32_t* __restrict__ limit;
  const int32_t* __restrict__ n_cand;
  const int32_t* __restrict__ eval_of;
  const uint8_t* __restrict__ penalty;
  const T* __restrict__ ask;
  const int32_t* __restrict__ desired;
  const uint8_t* __restrict__ real;
  const T* __restrict__ pre_cpu;
  const T* __restrict__ pre_mem;
  const T* __restrict__ pre_disk;
  const T* __restrict__ policy_tput;
  const T* __restrict__ policy_has;
  const T* __restrict__ policy_mig;
  T* scores;
  uint8_t* feas;
  T* s_walk;
  uint8_t* f_walk;
  T* free_cap;
  T* price;
  void* round;
  int32_t* progress;
  int32_t* pulls0;
  int32_t* assigned;
  int32_t* out_pulls;
  int32_t* acc_round;
  T* out_score;
  int32_t* rows0;
  int32_t* out_rounds;
  long long* stamps;
  int E, A, C, max_rounds;
  bool spread_fit;
};

// Pass 1: score and feasibility of every (row, node) pair.
template <typename T, bool kPolicy>
__global__ void __launch_bounds__(kScoreThreads)
    storm_score_kernel(const Storm<T> p) {
  const int a = blockIdx.y;
  const int c = blockIdx.x * kScoreThreads + threadIdx.x;
  if (p.stamps != nullptr && a == 0 && c == 0) stamp(p.stamps + 1);
  if (c >= p.C) return;
  const int e = p.eval_of[a];
  const size_t ec = static_cast<size_t>(e) * p.C + c;
  const size_t ac = static_cast<size_t>(a) * p.C + c;
  // the JAX program adds the staged deltas to the usage first, then
  // the ask, each rounded on its own
  const T cpu_after = (p.cpu_used[c] + p.pre_cpu[c]) + p.ask[3 * a];
  const T mem_after = (p.mem_used[c] + p.pre_mem[c]) + p.ask[3 * a + 1];
  const T disk_after = (p.disk_used[c] + p.pre_disk[c]) + p.ask[3 * a + 2];
  const T cpu_total = p.cpu_total[c];
  const T mem_total = p.mem_total[c];
  const bool fit = (cpu_after <= cpu_total) & (mem_after <= mem_total) &
                   (disk_after <= p.disk_total[c]);
  p.feas[ac] = (p.feasible[ec] != 0) & fit & (p.real[a] != 0);
  nk::PolicyNode<T> pol;
  if (kPolicy) {
    pol.tput_on = true;
    pol.tput = p.policy_tput[ec];
    pol.has_tput = p.policy_has[e];
    pol.mig_on = true;
    pol.mig = p.policy_mig[ec];
  }
  p.scores[ac] = nk::score_node<T, false, false, kPolicy>(
      cpu_total, mem_total, cpu_after, mem_after, p.collisions[ec],
      p.penalty[ac] != 0, p.affinity[ec], T(0),
      static_cast<T>(p.desired[a]), p.spread_fit, T(0), false, pol);
}

// Pass 2: each row's warm start, K1's limited walk over its eval's
// walk order.
template <typename T>
__global__ void __launch_bounds__(nk::kThreads)
    storm_walk_kernel(const Storm<T> p) {
  const int a = blockIdx.x;
  if (p.stamps != nullptr && a == 0 && threadIdx.x == 0) stamp(p.stamps + 2);
  const int e = p.eval_of[a];
  const int32_t* perm = p.perm + static_cast<size_t>(e) * p.C;
  const T* scores = p.scores + static_cast<size_t>(a) * p.C;
  const uint8_t* feas = p.feas + static_cast<size_t>(a) * p.C;
  auto score_at = [&](int w, T& s, bool& f) {
    const int node = perm[w];
    s = scores[node];
    f = feas[node] != 0;
  };
  const nk::WalkOut<T> r = nk::limited_walk<T>(
      p.C, p.limit[e], p.n_cand[e], p.s_walk + static_cast<size_t>(a) * p.C,
      p.f_walk + static_cast<size_t>(a) * p.C, score_at);
  if (threadIdx.x == 0) {
    p.rows0[a] = r.any ? perm[r.win_w] : nk::kNoNode;
    p.pulls0[a] = r.pulls;
  }
}

// Pass 3: the auction, one cooperative launch: the mirror's free
// capacity and zero prices, then storm_round.cuh's rounds over the arena
// as one shard.
template <typename T>
struct OneShard {
  const T* scores;
  const uint8_t* feas;
  T* free;
  T* price;
  __device__ storm::ShardView<T> view(int) const {
    return {scores, feas, free, price};
  }
};

template <typename T>
__global__ void __launch_bounds__(storm::kThreads, 1)
    storm_auction_kernel(const Storm<T> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const int gsize = gridDim.x * blockDim.x;
  for (int c = gtid; c < p.C; c += gsize) {
    p.free_cap[3 * c] = p.cpu_total[c] - (p.cpu_used[c] + p.pre_cpu[c]);
    p.free_cap[3 * c + 1] = p.mem_total[c] - (p.mem_used[c] + p.pre_mem[c]);
    p.free_cap[3 * c + 2] =
        p.disk_total[c] - (p.disk_used[c] + p.pre_disk[c]);
    p.price[c] = T(0);
  }
  for (int a = gtid; a < p.A; a += gsize) {
    p.assigned[a] = nk::kNoNode;
    p.acc_round[a] = -1;
  }
  storm::Round<T> r;
  r.ask = p.ask;
  r.real = p.real;
  r.rows0 = p.rows0;
  r.pulls0 = p.pulls0;
  r.n_cand = p.n_cand;
  r.eval_of = p.eval_of;
  r.assigned = p.assigned;
  r.acc_round = p.acc_round;
  r.progress = p.progress;
  r.out_pulls = p.out_pulls;
  r.out_score = p.out_score;
  r.out_rounds = p.out_rounds;
  r.round = p.round;
  r.stamps = p.stamps;
  r.A = p.A;
  r.C = p.C;
  r.S = p.C;
  r.D = 1;
  r.max_rounds = p.max_rounds;
  storm::run_auction<T>(r, OneShard<T>{p.scores, p.feas, p.free_cap, p.price},
                        smem);
}

template <typename T>
Storm<T> typed(const StormArgs& a) {
  Storm<T> p;
  p.cpu_total = static_cast<const T*>(a.cpu_total);
  p.mem_total = static_cast<const T*>(a.mem_total);
  p.disk_total = static_cast<const T*>(a.disk_total);
  p.cpu_used = static_cast<const T*>(a.cpu_used);
  p.mem_used = static_cast<const T*>(a.mem_used);
  p.disk_used = static_cast<const T*>(a.disk_used);
  p.feasible = static_cast<const uint8_t*>(a.feasible);
  p.affinity = static_cast<const T*>(a.affinity);
  p.collisions = static_cast<const int32_t*>(a.collisions);
  p.perm = static_cast<const int32_t*>(a.perm);
  p.limit = static_cast<const int32_t*>(a.limit);
  p.n_cand = static_cast<const int32_t*>(a.n_cand);
  p.eval_of = static_cast<const int32_t*>(a.eval_of);
  p.penalty = static_cast<const uint8_t*>(a.penalty);
  p.ask = static_cast<const T*>(a.ask);
  p.desired = static_cast<const int32_t*>(a.desired);
  p.real = static_cast<const uint8_t*>(a.real);
  p.pre_cpu = static_cast<const T*>(a.pre_cpu);
  p.pre_mem = static_cast<const T*>(a.pre_mem);
  p.pre_disk = static_cast<const T*>(a.pre_disk);
  p.policy_tput = static_cast<const T*>(a.policy_tput);
  p.policy_has = static_cast<const T*>(a.policy_has);
  p.policy_mig = static_cast<const T*>(a.policy_mig);
  p.scores = static_cast<T*>(a.scores);
  p.feas = static_cast<uint8_t*>(a.feas);
  p.s_walk = static_cast<T*>(a.s_walk);
  p.f_walk = static_cast<uint8_t*>(a.f_walk);
  p.free_cap = static_cast<T*>(a.free_cap);
  p.price = static_cast<T*>(a.price);
  p.round = a.round;
  p.progress = static_cast<int32_t*>(a.progress);
  p.pulls0 = static_cast<int32_t*>(a.pulls0);
  p.assigned = static_cast<int32_t*>(a.out_assigned);
  p.out_pulls = static_cast<int32_t*>(a.out_pulls);
  p.acc_round = static_cast<int32_t*>(a.out_round);
  p.out_score = static_cast<T*>(a.out_score);
  p.rows0 = static_cast<int32_t*>(a.out_greedy);
  p.out_rounds = static_cast<int32_t*>(a.out_rounds);
  p.stamps = static_cast<long long*>(a.stamps);
  p.E = a.E;
  p.A = a.A;
  p.C = a.C;
  p.max_rounds = a.max_rounds;
  p.spread_fit = a.spread_fit != 0;
  return p;
}

template <typename T>
cudaError_t launch(StormArgs& a, cudaStream_t s) {
  Storm<T> p = typed<T>(a);
  const dim3 score_grid((a.C + kScoreThreads - 1) / kScoreThreads, a.A);
  if (a.policy_tput != nullptr) {
    storm_score_kernel<T, true><<<score_grid, kScoreThreads, 0, s>>>(p);
  } else {
    storm_score_kernel<T, false><<<score_grid, kScoreThreads, 0, s>>>(p);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  storm_walk_kernel<T><<<a.A, nk::kThreads, 0, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // every block of a cooperative launch must be resident at once
  const void* kern = reinterpret_cast<const void*>(storm_auction_kernel<T>);
  const size_t smem = storm::smem_bytes(a.A, sizeof(T));
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, storm_auction_kernel<T>, storm::kThreads, smem);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                               a.device);
  if (err != cudaSuccess) return err;
  const int blocks = min(a.max_blocks > 0 ? a.max_blocks : per_sm * sms,
                         storm::kMaxGrid);
  if (blocks < 1) return cudaErrorCooperativeLaunchTooLarge;
  a.blocks = blocks;
  void* kargs[] = {&p};
  err = cudaLaunchCooperativeKernel(kern, dim3(blocks), dim3(storm::kThreads),
                                    kargs, smem, s);
  // a refused launch also sets the runtime's last error: clear it, or
  // the next launch's check would report it again
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

}  // namespace

extern "C" int nk_storm_solve(StormArgs* a, void* stream) {
  cudaError_t err = cudaSetDevice(a->device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = a->is_f64 ? launch<double>(*a, s) : launch<float>(*a, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Bytes of the round scratch (StormArgs.round) of an A-row solve over C
// nodes.
extern "C" long long nk_storm_round_bytes(int A, int C, int is_f64) {
  return static_cast<long long>(storm::scratch_bytes(
      A, C, 1, is_f64 ? sizeof(double) : sizeof(float)));
}

extern "C" int nk_storm_args_size() {
  return static_cast<int>(sizeof(StormArgs));
}

extern "C" const char* nk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
