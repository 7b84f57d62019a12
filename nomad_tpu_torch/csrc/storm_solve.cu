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
//   3. auction (one cooperative launch): the while_loop stays on the
//      card.  The round counter and the progress flags live in device
//      memory and every block reads them after a grid barrier, so no
//      host round trip happens per round.  A round is three phases
//      between grid barriers:
//        B  one block per row: the bid, an argmax of value + jitter
//           over the row's nodes (first index on ties; an all -inf row
//           picks node 0 and makes no bid), round 0 bidding the walk
//           winner when it still fits;
//        R  one thread per row: its rank among its node's bidders
//           (value descending, ties to the lower row), the node's
//           largest bidder ask per dimension, m = min_d floor(free /
//           max(maxask, 1e-9)) over the dimensions with maxask > 0,
//           and acceptance (rank 0, or rank < m);
//        D  the lowest bidder of each node: the node's accepted asks
//           summed in ascending row order and subtracted from its free
//           capacity once (the twin's order), and its price raised.
//      The epilogue writes pulls (the walk's when the greedy pick
//      held, else the row's candidate count), the score of the
//      assignment and the round count.
//   Why a cooperative launch and not a launch per phase: the loop runs
//   up to A = 1,024 rounds; three launches a round, each returning at
//   once when a device flag says the loop is done, would enqueue
//   ~3,000 launches per solve whatever the rounds actually run.
//
// Exactness: as K1-K3 — score_node's float ops in the JAX program's
// order, each rounded on its own (-fmad=false), with the one fma XLA
// forms written explicitly; the jitter is the int32 Knuth-hash lattice
// computed in uint32 (the same low 16 bits) and scaled as the twin
// scales it; max is exact in any order; the debit adds in ascending
// row order, which equals XLA's dot for whole-valued asks.
//
// What bounds it on an H100: the score pass writes the [A, C] matrix
// (128 MiB in f64 at A = 1,024, C = 16,384; a weighted storm reads two
// more [E, C] rows, 256 MiB at E = 1,024) and every auction round
// re-reads the unassigned rows of it, so it is bound by bytes; the
// walk pass is K1's latency-bound walk, one block per row, ~8 rows per
// SM at full width.
//
// Launch: nothing is allocated here (the wrapper passes the scratch)
// and nothing is synchronised.

#include <cooperative_groups.h>

#include "walk.cuh"

namespace cg = cooperative_groups;

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
  void* bid_v;     // T [A] scratch
  void* bid_c;     // int32 [A] scratch
  void* has_bid;   // int32 [A] scratch
  void* accepted;  // int32 [A] scratch
  void* progress;  // int32 [max(1, max_rounds)] scratch
  void* pulls0;    // int32 [A] scratch
  void* out_assigned;  // int32 [A]
  void* out_pulls;     // int32 [A]
  void* out_round;     // int32 [A]
  void* out_score;     // T [A]
  void* out_greedy;    // int32 [A] (the warm start's rows0)
  void* out_rounds;    // int32 [1]
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
constexpr int kAucThreads = 256;
constexpr int kAucWarps = kAucThreads / 32;
constexpr uint32_t kJitterRow = 0x9E3779B9u;  // int32 -1640531527
constexpr uint32_t kJitterNode = 40503u;

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
  T* bid_v;
  int32_t* bid_c;
  int32_t* has_bid;
  int32_t* accepted;
  int32_t* progress;
  int32_t* pulls0;
  int32_t* assigned;
  int32_t* out_pulls;
  int32_t* acc_round;
  T* out_score;
  int32_t* rows0;
  int32_t* out_rounds;
  int E, A, C, max_rounds;
  bool spread_fit;
};

// Pass 1: score and feasibility of every (row, node) pair.
template <typename T, bool kPolicy>
__global__ void __launch_bounds__(kScoreThreads)
    storm_score_kernel(const Storm<T> p) {
  const int a = blockIdx.y;
  const int c = blockIdx.x * kScoreThreads + threadIdx.x;
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

template <typename T>
__device__ __forceinline__ T jitter(int a, int c) {
  // (row * -1640531527 + node * 40503) & 0xFFFF with int32 wraparound:
  // uint32 arithmetic keeps the same low 16 bits
  const uint32_t h =
      (static_cast<uint32_t>(a) * kJitterRow +
       static_cast<uint32_t>(c) * kJitterNode) & 0xFFFFu;
  return static_cast<T>(h) / T(65536) * static_cast<T>(1e-6);
}

// bid key: larger value + jitter first, then the lower node index
template <typename T>
__device__ __forceinline__ bool bid_better(T vj, int c, T bvj, int bc) {
  return vj > bvj || (vj == bvj && c < bc);
}

// Pass 3: the auction, one cooperative launch.
template <typename T>
__global__ void __launch_bounds__(kAucThreads)
    storm_auction_kernel(const Storm<T> p) {
  cg::grid_group grid = cg::this_grid();
  __shared__ T red_vj[kAucWarps];
  __shared__ T red_v[kAucWarps];
  __shared__ int red_c[kAucWarps];

  const int A = p.A;
  const int C = p.C;
  const int tid = threadIdx.x;
  const int gtid = blockIdx.x * blockDim.x + tid;
  const int gsize = gridDim.x * blockDim.x;
  const T neg_inf = -INFINITY;

  for (int c = gtid; c < C; c += gsize) {
    p.free_cap[3 * c] = p.cpu_total[c] - (p.cpu_used[c] + p.pre_cpu[c]);
    p.free_cap[3 * c + 1] = p.mem_total[c] - (p.mem_used[c] + p.pre_mem[c]);
    p.free_cap[3 * c + 2] =
        p.disk_total[c] - (p.disk_used[c] + p.pre_disk[c]);
    p.price[c] = T(0);
  }
  for (int a = gtid; a < A; a += gsize) {
    p.assigned[a] = nk::kNoNode;
    p.acc_round[a] = -1;
  }
  for (int r = gtid; r < p.max_rounds; r += gsize) p.progress[r] = 0;
  grid.sync();

  int rnd = 0;
  bool progress = true;
  while (rnd < p.max_rounds && progress) {
    // ---- B: one block per row bids ----
    for (int a = blockIdx.x; a < A; a += gridDim.x) {
      const bool unass =
          __ldcg(p.assigned + a) == nk::kNoNode && p.real[a] != 0;
      if (!unass) {
        if (tid == 0) {
          p.has_bid[a] = 0;
          p.bid_c[a] = 0;
          p.bid_v[a] = neg_inf;
        }
        continue;  // block-uniform
      }
      const T ask0 = p.ask[3 * a];
      const T ask1 = p.ask[3 * a + 1];
      const T ask2 = p.ask[3 * a + 2];
      const T* srow = p.scores + static_cast<size_t>(a) * C;
      const uint8_t* frow = p.feas + static_cast<size_t>(a) * C;
      T best_vj = neg_inf;
      T best_v = neg_inf;
      int best_c = nk::kInt32Max;
      for (int c = tid; c < C; c += kAucThreads) {
        const bool ok = frow[c] != 0 &&
                        __ldcg(p.free_cap + 3 * c) >= ask0 &&
                        __ldcg(p.free_cap + 3 * c + 1) >= ask1 &&
                        __ldcg(p.free_cap + 3 * c + 2) >= ask2;
        const T value = ok ? srow[c] - __ldcg(p.price + c) : neg_inf;
        const T vj = value + jitter<T>(a, c);
        if (bid_better(vj, c, best_vj, best_c)) {
          best_vj = vj;
          best_v = value;
          best_c = c;
        }
      }
      const int lane = tid & 31;
      const int warp = tid >> 5;
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) {
        const T ovj = __shfl_down_sync(nk::kFull, best_vj, d);
        const T ov = __shfl_down_sync(nk::kFull, best_v, d);
        const int oc = __shfl_down_sync(nk::kFull, best_c, d);
        if (bid_better(ovj, oc, best_vj, best_c)) {
          best_vj = ovj;
          best_v = ov;
          best_c = oc;
        }
      }
      if (lane == 0) {
        red_vj[warp] = best_vj;
        red_v[warp] = best_v;
        red_c[warp] = best_c;
      }
      __syncthreads();
      if (tid == 0) {
        for (int w = 1; w < kAucWarps; ++w) {
          if (bid_better(red_vj[w], red_c[w], best_vj, best_c)) {
            best_vj = red_vj[w];
            best_v = red_v[w];
            best_c = red_c[w];
          }
        }
        // round 0 bids the serial walk winner when it still fits
        const int r0 = p.rows0[a];
        const int r0c = min(max(r0, 0), C - 1);
        const bool ok0 = frow[r0c] != 0 &&
                         __ldcg(p.free_cap + 3 * r0c) >= ask0 &&
                         __ldcg(p.free_cap + 3 * r0c + 1) >= ask1 &&
                         __ldcg(p.free_cap + 3 * r0c + 2) >= ask2;
        const T walk_v = ok0 ? srow[r0c] - __ldcg(p.price + r0c) : neg_inf;
        const bool use_walk = rnd == 0 && r0 >= 0 && walk_v > neg_inf;
        const int bc = use_walk ? r0c : best_c;
        const T bv = use_walk ? walk_v : best_v;
        p.bid_c[a] = bc;
        p.bid_v[a] = bv;
        p.has_bid[a] = bv > neg_inf ? 1 : 0;
      }
      __syncthreads();  // red_* is reused by the block's next row
    }
    grid.sync();

    // ---- R: one thread per row ranks and accepts ----
    for (int i = gtid; i < A; i += gsize) {
      int acc = 0;
      if (__ldcg(p.has_bid + i)) {
        const int c = __ldcg(p.bid_c + i);
        const T v = __ldcg(p.bid_v + i);
        int rank = 0;
        T mx0 = T(0), mx1 = T(0), mx2 = T(0);
        for (int j = 0; j < A; ++j) {
          if (!__ldcg(p.has_bid + j) || __ldcg(p.bid_c + j) != c) continue;
          const T vj = __ldcg(p.bid_v + j);
          if (vj > v || (vj == v && j < i)) ++rank;
          mx0 = fmax(mx0, p.ask[3 * j]);
          mx1 = fmax(mx1, p.ask[3 * j + 1]);
          mx2 = fmax(mx2, p.ask[3 * j + 2]);
        }
        const T tiny = static_cast<T>(1e-9);
        const T mx[3] = {mx0, mx1, mx2};
        T m = INFINITY;
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          if (mx[d] > T(0)) {
            const T q = floor(__ldcg(p.free_cap + 3 * c + d) /
                              (mx[d] > tiny ? mx[d] : tiny));
            m = q < m ? q : m;
          }
        }
        if (rank == 0 || static_cast<T>(rank) < m) {
          acc = 1;
          p.assigned[i] = c;
          p.acc_round[i] = rnd;
          p.progress[rnd] = 1;
        }
      }
      p.accepted[i] = acc;
    }
    grid.sync();

    // ---- D: each node's lowest bidder debits and prices it ----
    for (int i = gtid; i < A; i += gsize) {
      if (!__ldcg(p.has_bid + i)) continue;
      const int c = __ldcg(p.bid_c + i);
      bool first = true;
      for (int j = 0; j < i; ++j) {
        if (__ldcg(p.has_bid + j) && __ldcg(p.bid_c + j) == c) {
          first = false;
          break;
        }
      }
      if (!first) continue;
      T s0 = T(0), s1 = T(0), s2 = T(0);
      bool any = false;
      for (int j = i; j < A; ++j) {
        if (__ldcg(p.accepted + j) && __ldcg(p.bid_c + j) == c) {
          s0 = s0 + p.ask[3 * j];
          s1 = s1 + p.ask[3 * j + 1];
          s2 = s2 + p.ask[3 * j + 2];
          any = true;
        }
      }
      if (any) {
        p.free_cap[3 * c] = __ldcg(p.free_cap + 3 * c) - s0;
        p.free_cap[3 * c + 1] = __ldcg(p.free_cap + 3 * c + 1) - s1;
        p.free_cap[3 * c + 2] = __ldcg(p.free_cap + 3 * c + 2) - s2;
      }
      p.price[c] = __ldcg(p.price + c) + static_cast<T>(0.01);
    }
    grid.sync();
    progress = __ldcg(p.progress + rnd) != 0;
    ++rnd;
  }

  // ---- epilogue ----
  for (int a = gtid; a < A; a += gsize) {
    const int asg = p.assigned[a];
    const bool solved = asg >= 0;
    const bool kept_walk = solved && asg == p.rows0[a];
    p.out_pulls[a] = kept_walk ? p.pulls0[a] : p.n_cand[p.eval_of[a]];
    p.out_score[a] =
        solved ? p.scores[static_cast<size_t>(a) * C + min(asg, C - 1)]
               : T(0);
  }
  if (gtid == 0) p.out_rounds[0] = rnd;
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
  p.bid_v = static_cast<T*>(a.bid_v);
  p.bid_c = static_cast<int32_t*>(a.bid_c);
  p.has_bid = static_cast<int32_t*>(a.has_bid);
  p.accepted = static_cast<int32_t*>(a.accepted);
  p.progress = static_cast<int32_t*>(a.progress);
  p.pulls0 = static_cast<int32_t*>(a.pulls0);
  p.assigned = static_cast<int32_t*>(a.out_assigned);
  p.out_pulls = static_cast<int32_t*>(a.out_pulls);
  p.acc_round = static_cast<int32_t*>(a.out_round);
  p.out_score = static_cast<T*>(a.out_score);
  p.rows0 = static_cast<int32_t*>(a.out_greedy);
  p.out_rounds = static_cast<int32_t*>(a.out_rounds);
  p.E = a.E;
  p.A = a.A;
  p.C = a.C;
  p.max_rounds = a.max_rounds;
  p.spread_fit = a.spread_fit != 0;
  return p;
}

template <typename T>
cudaError_t launch(const StormArgs& a, cudaStream_t s) {
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
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, storm_auction_kernel<T>, kAucThreads, 0);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                               a.device);
  if (err != cudaSuccess) return err;
  const int blocks = max(1, min(per_sm * sms, a.A));
  void* kargs[] = {&p};
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(storm_auction_kernel<T>), dim3(blocks),
      dim3(kAucThreads), kargs, 0, s);
}

}  // namespace

extern "C" int nk_storm_solve(const StormArgs* a, void* stream) {
  cudaError_t err = cudaSetDevice(a->device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = a->is_f64 ? launch<double>(*a, s) : launch<float>(*a, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
