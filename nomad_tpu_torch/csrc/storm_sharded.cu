// Kernel K14: the node-sharded storm assignment — K5's solve with the
// node axis split over a mesh — behind the batch worker's storm path on
// a node mesh (NOMAD_TPU_MESH=1 with NOMAD_TPU_STORM=1).
//
// On a VirtualMesh (every shard in this process, on one card, at most
// kMaxCoopShards) the score stage a shard, the mesh's gather and the walk
// are launched as below, then the rounds and the epilogue are ONE
// cooperative launch (k_auction_coop): csrc/storm_round.cuh's rounds
// (K5's) over the D shards, whose argument blocks are the launch's own
// parameters (StormCoopTable, by value).  The exchanges stay in device
// memory with the mesh's semantics: the bids reduce by (value + jitter,
// lowest id) over (row, shard) items (pmax, then pmin of the ids at the
// max), and reads at a node are the owner's value plus +0.0 from every
// other shard in shard order (psum).  The progress flag is read on the
// card: no host read a round.
//
// On a DistMesh (the shards spread over processes) one launch per stage
// and shard, with the mesh's collectives between them
// (nomad_tpu_torch/ops/solve.py _drive_storm drives them); the stages
// share storm_round.cuh's jitter, bid order and budget.
//
// Replaces the JAX program nomad_tpu/ops/solve.py:354
// storm_assignment_sharded (its shard_map body _run, :406-620).  Plain
// twin: ops/solve.py _StormTwinStages (the same stages in torch, on the
// same mesh).
//
// The stages, in the order the driver launches them:
//   score     (per shard, node tiles x rows) feasibility and score of
//             every (row, local node) pair into [A, S] scratch, through
//             walk.cuh's score_node (K5's score pass on the shard's
//             mirror columns plus pre-deltas, the row's eval slice, the
//             policy rows when weighted, the row's `real` flag); the
//             shard's free capacity and zero prices;
//   walk      (per process, one block of 1,024 threads per row) after
//             the mesh gathers the [A, S] scores and feasibility of every
//             shard: K5's warm start, K1's limited walk over the row's
//             permutation of the gathered [A, C] matrix -> rows0, pulls0;
// then, each auction round:
//   bid       (per shard, one block per row) the local max of value +
//             jitter over the shard's nodes and the lowest global node id
//             that reaches it (jitter from global ids); pmax of the max;
//   cand      (per shard) that id where the shard's max is the global
//             one, else INT32_MAX; pmin -> each row's best node;
//   read      (per shard) ownership reads of the row's value at its best
//             node and, in round 0, at its walk winner: the owner's value,
//             0.0 from every other shard; psum;
//   bids      (per process) each row's bid: the walk winner in round 0
//             when it still fits, else the best node;
//   budget    (per shard) for each row bidding a node of the shard, the
//             node's largest bidder ask per dimension and m = min_d
//             floor(free / max(maxask, 1e-9)) over dimensions with
//             maxask > 0; 0.0 off the shard; psum;
//   accept    (per process) the [A, A] rank (value descending, ties to
//             the lower row) and acceptance (rank 0, or rank < m); sets
//             the round's progress flag, which the host reads;
//   debit     (per shard) each node's accepted asks summed in ascending
//             row order and subtracted once (K5's D phase), and its price
//             raised where it had a bidder;
// and the epilogue:
//   epi_read  (per shard) the ownership read of the assignment's score;
//             psum;
//   finish    (per process) pulls (the walk's where the greedy pick held,
//             else the row's candidate count), the score and the rounds.
//
// Exactness: the sharded program's order, not K5's.  Reads go through a
// psum of the owner's term and +0.0 from every other shard (so a -0.0
// score reads +0.0 at D > 1, as in the JAX program), and the debit is
// per shard.  score_node's float ops run in the JAX program's order, each
// rounded on its own (-fmad=false), with the one fma XLA forms written
// explicitly; the jitter is the int32 Knuth-hash lattice computed in
// uint32; max and min are exact in any order; the debit adds in ascending
// row order, which equals XLA's dot for whole-valued asks.
//
// What bounds it on an H100: the score pass writes the [A, C] matrix
// across the shards and the walk reads it once gathered (bytes); each
// round's bid re-reads the bidding rows of it.  Staged, launch latency
// dominates: 5 launches a shard and 2 a process every round, plus the
// exchanges and the host's read of the progress flag.
//
// Launch: on the caller's stream; nothing is allocated or synchronised.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "storm_round.cuh"
#include "walk.cuh"

// Mirrored field for field by the ctypes Structure in ops/_cuda.py.
struct StormShardedArgs {
  // this shard's node columns [S]: the sharded usage mirror, read in place
  const void* cpu_total;
  const void* mem_total;
  const void* disk_total;
  const void* cpu_used;
  const void* mem_used;
  const void* disk_used;
  const void* pre_cpu;  // T [S] staged pre-placement deltas
  const void* pre_mem;
  const void* pre_disk;
  // this shard's node-indexed inputs
  const uint8_t* feasible;    // [E, S]
  const void* affinity;       // T [E, S]
  const int32_t* collisions;  // [E, S]
  const uint8_t* penalty;     // [A, S]
  const void* policy_tput;    // T [E, S] or null (unweighted)
  const void* policy_mig;     // T [E, S] or null
  // replicated inputs
  const int32_t* perm;     // [E, C]
  const int32_t* limit;    // [E]
  const int32_t* n_cand;   // [E]
  const int32_t* eval_of;  // [A]
  const void* ask;         // T [A, 3]
  const int32_t* desired;  // [A]
  const uint8_t* real;     // [A]
  const void* policy_has;  // T [E] or null
  // this shard's state and scratch
  void* scores_l;       // T [A, S]
  uint8_t* feas_l;      // [A, S]
  void* free_l;         // T [S, 3]
  void* price_l;        // T [S]
  void* rec_max;        // T [A] local max of value + jitter
  int32_t* rec_idx;     // [A] lowest global node id at it
  int32_t* cand;        // [A] rec_idx where the max is global
  void* terms;          // T [2, A] reads at the best node, the walk winner
  void* m_term;         // T [A] m at the bid node (owner) or 0
  void* score_term;     // T [A] the assignment's score (owner) or 0
  // exchanged (one copy per process)
  const void* scores_g;     // T [D, A, S] gathered scores
  const uint8_t* feas_g;    // [D, A, S] gathered feasibility
  void* s_walk;             // T [A, C] walk scratch
  uint8_t* f_walk;          // [A, C] walk scratch
  const void* gmax;         // T [A] pmax of rec_max
  const int32_t* best_c;    // [A] pmin of cand
  const void* reads;        // T [2, A] psum of terms
  const void* m_at_bid;     // T [A] psum of m_term
  const void* score_read;   // T [A] psum of score_term
  // replicated state and outputs
  int32_t* rows0;      // [A] the warm start (the greedy output)
  int32_t* pulls0;     // [A]
  int32_t* bid_c;      // [A]
  void* bid_v;         // T [A]
  int32_t* has_bid;    // [A]
  int32_t* accepted;   // [A]
  int32_t* assigned;   // [A]
  int32_t* acc_round;  // [A]
  int32_t* progress;   // [max(1, max_rounds)] one flag a round
  int32_t* out_pulls;  // [A]
  void* out_score;     // T [A]
  int32_t* out_rounds;  // [1]
  long long* stamps;    // storm_round.cuh's stamp buffer, or null
  int E;
  int A;
  int C;
  int S;
  int D;
  int shard;  // -1 for the per-process stages
  int lo;     // shard * S
  int rnd;
  int max_rounds;
  int stage;
  int spread_fit;
  int is_f64;
  int device;
};

// The D per-shard argument blocks of a cooperative solve, passed to the
// kernel by value (CUDA 12.1's large kernel parameters, up to 32,764
// bytes on sm_70 and later), with the round scratch.
constexpr int kMaxCoopShards = 32;

struct StormCoopTable {
  StormShardedArgs sh[kMaxCoopShards];
  int D;
};

struct StormCoopParams {
  StormCoopTable table;
  void* round;  // storm::scratch_bytes(A, C, D) bytes of scratch
};

static_assert(sizeof(StormCoopParams) <= 32764,
              "StormCoopParams exceeds the kernel parameter limit");
#if CUDART_VERSION < 12010
#error "K14's cooperative solve needs CUDA 12.1's large kernel parameters"
#endif

// The cooperative launch of one solve's rounds and epilogue.  Mirrored
// by the ctypes Structure in ops/_cuda.py.
struct StormCoopLaunch {
  StormCoopParams params;  // passed to the kernel by value
  int is_f64;
  int device;
  int max_blocks;  // 0: as many blocks as the card holds at once
  int blocks;      // out: the grid launched
};

namespace {

using nk::kInt32Max;
using nk::kNoNode;

enum Stage {
  kScore = 0,
  kWalk,
  kBid,
  kCand,
  kRead,
  kBids,
  kBudget,
  kAccept,
  kDebit,
  kEpiRead,
  kFinish,
};

constexpr int kScoreThreads = 256;
constexpr int kBidThreads = 256;
constexpr int kBidWarps = kBidThreads / 32;
constexpr int kRowThreads = 128;
using storm::bid_better;
using storm::jitter;

// typed views of the untyped pointers
template <typename T>
struct V {
  const StormShardedArgs& a;
  __device__ const T* t(const void* p) const { return static_cast<const T*>(p); }
  __device__ T* w(void* p) const { return static_cast<T*>(p); }
};

template <typename T>
__device__ __forceinline__ bool unassigned(const StormShardedArgs& a, int r) {
  return a.assigned[r] == kNoNode && a.real[r] != 0;
}

// value_l of row r at local node l: score - price where the node is
// feasible and its free capacity fits the ask, else -inf (the row must be
// unassigned; the caller checks)
template <typename T>
__device__ __forceinline__ T local_value(const StormShardedArgs& a, int r,
                                         int l) {
  const V<T> x{a};
  const size_t rl = static_cast<size_t>(r) * a.S + l;
  const T* ask = x.t(a.ask) + 3 * r;
  const T* free = x.t(a.free_l) + 3 * l;
  const bool ok = a.feas_l[rl] != 0 && free[0] >= ask[0] &&
                  free[1] >= ask[1] && free[2] >= ask[2];
  return ok ? x.t(a.scores_l)[rl] - x.t(a.price_l)[l] : T(-INFINITY);
}

// the ownership read of value_l at global node g: the owner's value,
// +0.0 on every other shard
template <typename T>
__device__ __forceinline__ T value_term(const StormShardedArgs& a, int r,
                                        int g) {
  const int l = g - a.lo;
  if (l < 0 || l >= a.S) return T(0);
  return unassigned<T>(a, r) ? local_value<T>(a, r, l) : T(-INFINITY);
}

template <typename T, bool kPolicy>
__global__ void __launch_bounds__(kScoreThreads) k_score(StormShardedArgs a) {
  const V<T> x{a};
  const int r = blockIdx.y;
  const int l = blockIdx.x * kScoreThreads + threadIdx.x;
  if (a.stamps != nullptr && a.shard == 0 && r == 0 && l == 0) {
    storm::stamp(a.stamps + 1);
  }
  if (l >= a.S) return;
  const int e = a.eval_of[r];
  const size_t el = static_cast<size_t>(e) * a.S + l;
  const size_t rl = static_cast<size_t>(r) * a.S + l;
  const T* ask = x.t(a.ask) + 3 * r;
  // the staged deltas are added to the usage first, then the ask, each
  // rounded on its own (the JAX program's order)
  const T cpu_u = x.t(a.cpu_used)[l] + x.t(a.pre_cpu)[l];
  const T mem_u = x.t(a.mem_used)[l] + x.t(a.pre_mem)[l];
  const T disk_u = x.t(a.disk_used)[l] + x.t(a.pre_disk)[l];
  const T cpu_total = x.t(a.cpu_total)[l];
  const T mem_total = x.t(a.mem_total)[l];
  const T disk_total = x.t(a.disk_total)[l];
  const T cpu_after = cpu_u + ask[0];
  const T mem_after = mem_u + ask[1];
  const T disk_after = disk_u + ask[2];
  const bool fit = (cpu_after <= cpu_total) & (mem_after <= mem_total) &
                   (disk_after <= disk_total);
  a.feas_l[rl] = (a.feasible[el] != 0) & fit & (a.real[r] != 0);
  nk::PolicyNode<T> pol;
  if (kPolicy) {
    pol.tput_on = true;
    pol.tput = x.t(a.policy_tput)[el];
    pol.has_tput = x.t(a.policy_has)[e];
    pol.mig_on = true;
    pol.mig = x.t(a.policy_mig)[el];
  }
  x.w(a.scores_l)[rl] = nk::score_node<T, false, false, kPolicy>(
      cpu_total, mem_total, cpu_after, mem_after, a.collisions[el],
      a.penalty[rl] != 0, x.t(a.affinity)[el], T(0),
      static_cast<T>(a.desired[r]), a.spread_fit != 0, T(0), false, pol);
  if (r == 0) {
    T* free = x.w(a.free_l) + 3 * l;
    free[0] = cpu_total - cpu_u;
    free[1] = mem_total - mem_u;
    free[2] = disk_total - disk_u;
    x.w(a.price_l)[l] = T(0);
  }
}

template <typename T>
__global__ void __launch_bounds__(nk::kThreads) k_walk(StormShardedArgs a) {
  const V<T> x{a};
  const int r = blockIdx.x;
  if (a.stamps != nullptr && r == 0 && threadIdx.x == 0) {
    storm::stamp(a.stamps + 2);
  }
  const int e = a.eval_of[r];
  const int32_t* perm = a.perm + static_cast<size_t>(e) * a.C;
  const T* scores = x.t(a.scores_g);
  // the gathered [D, A, S] layout: node g lies in shard g / S
  auto score_at = [&](int w, T& s, bool& f) {
    const int g = perm[w];
    const int d = g / a.S;
    const size_t at = (static_cast<size_t>(d) * a.A + r) * a.S + (g - d * a.S);
    s = scores[at];
    f = a.feas_g[at] != 0;
  };
  const nk::WalkOut<T> out = nk::limited_walk<T>(
      a.C, a.limit[e], a.n_cand[e], x.w(a.s_walk) + static_cast<size_t>(r) * a.C,
      a.f_walk + static_cast<size_t>(r) * a.C, score_at);
  if (threadIdx.x == 0) {
    a.rows0[r] = out.any ? perm[out.win_w] : kNoNode;
    a.pulls0[r] = out.pulls;
    a.assigned[r] = kNoNode;
    a.acc_round[r] = -1;
  }
  if (r == 0) {
    for (int i = threadIdx.x; i < a.max_rounds; i += blockDim.x) a.progress[i] = 0;
  }
}

template <typename T>
__global__ void __launch_bounds__(kBidThreads) k_bid(StormShardedArgs a) {
  const V<T> x{a};
  __shared__ T red_vj[kBidWarps];
  __shared__ int red_c[kBidWarps];
  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  if (!unassigned<T>(a, r)) {
    // an assigned or padding row's values are all -inf: its max is -inf
    // at the shard's first node
    if (tid == 0) {
      x.w(a.rec_max)[r] = T(-INFINITY);
      a.rec_idx[r] = a.lo;
    }
    return;
  }
  T best_vj = T(-INFINITY);
  int best_c = kInt32Max;
  for (int l = tid; l < a.S; l += kBidThreads) {
    const int g = a.lo + l;
    const T vj = local_value<T>(a, r, l) + jitter<T>(r, g);
    if (bid_better(vj, g, best_vj, best_c)) {
      best_vj = vj;
      best_c = g;
    }
  }
  const int lane = tid & 31;
  const int warp = tid >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const T ovj = __shfl_down_sync(nk::kFull, best_vj, d);
    const int oc = __shfl_down_sync(nk::kFull, best_c, d);
    if (bid_better(ovj, oc, best_vj, best_c)) {
      best_vj = ovj;
      best_c = oc;
    }
  }
  if (lane == 0) {
    red_vj[warp] = best_vj;
    red_c[warp] = best_c;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kBidWarps; ++w) {
      if (bid_better(red_vj[w], red_c[w], best_vj, best_c)) {
        best_vj = red_vj[w];
        best_c = red_c[w];
      }
    }
    x.w(a.rec_max)[r] = best_vj;
    a.rec_idx[r] = best_c;
  }
}

template <typename T>
__global__ void k_cand(StormShardedArgs a) {
  const V<T> x{a};
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= a.A) return;
  a.cand[r] = x.t(a.rec_max)[r] == x.t(a.gmax)[r] ? a.rec_idx[r] : kInt32Max;
}

template <typename T>
__global__ void k_read(StormShardedArgs a) {
  const V<T> x{a};
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= a.A) return;
  T* terms = x.w(a.terms);
  terms[r] = value_term<T>(a, r, a.best_c[r]);
  T walk = T(0);  // only round 0 bids the walk winner
  if (a.rnd == 0) {
    const int r0c = min(max(a.rows0[r], 0), a.C - 1);
    walk = value_term<T>(a, r, r0c);
  }
  terms[a.A + r] = walk;
}

template <typename T>
__global__ void k_bids(StormShardedArgs a) {
  const V<T> x{a};
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= a.A) return;
  const T best_v = x.t(a.reads)[r];
  const T walk_v = x.t(a.reads)[a.A + r];
  const int r0 = a.rows0[r];
  const int r0c = min(max(r0, 0), a.C - 1);
  const bool use_walk = a.rnd == 0 && r0 >= 0 && walk_v > T(-INFINITY);
  const T bv = use_walk ? walk_v : best_v;
  a.bid_c[r] = use_walk ? r0c : a.best_c[r];
  x.w(a.bid_v)[r] = bv;
  a.has_bid[r] = bv > T(-INFINITY) ? 1 : 0;
}

template <typename T>
__global__ void k_budget(StormShardedArgs a) {
  const V<T> x{a};
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.A) return;
  const int c = a.bid_c[i];
  const int l = c - a.lo;
  if (l < 0 || l >= a.S) {
    x.w(a.m_term)[i] = T(0);
    return;
  }
  // the node's largest bidder ask per dimension (0 without bidders)
  const T* ask = x.t(a.ask);
  T mx0 = T(0), mx1 = T(0), mx2 = T(0);
  for (int j = 0; j < a.A; ++j) {
    if (!a.has_bid[j] || a.bid_c[j] != c) continue;
    mx0 = fmax(mx0, ask[3 * j]);
    mx1 = fmax(mx1, ask[3 * j + 1]);
    mx2 = fmax(mx2, ask[3 * j + 2]);
  }
  const T* free = x.t(a.free_l) + 3 * l;
  x.w(a.m_term)[i] = storm::budget<T>(free[0], free[1], free[2], mx0, mx1,
                                      mx2);
}

template <typename T>
__global__ void k_accept(StormShardedArgs a) {
  const V<T> x{a};
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.A) return;
  int acc = 0;
  if (a.has_bid[i]) {
    const int c = a.bid_c[i];
    const T* bid_v = x.t(a.bid_v);
    const T v = bid_v[i];
    int rank = 0;
    for (int j = 0; j < a.A; ++j) {
      if (!a.has_bid[j] || a.bid_c[j] != c) continue;
      const T vj = bid_v[j];
      if (vj > v || (vj == v && j < i)) ++rank;
    }
    if (rank == 0 || static_cast<T>(rank) < x.t(a.m_at_bid)[i]) {
      acc = 1;
      a.assigned[i] = c;
      a.acc_round[i] = a.rnd;
      a.progress[a.rnd] = 1;
    }
  }
  a.accepted[i] = acc;
}

template <typename T>
__global__ void k_debit(StormShardedArgs a) {
  const V<T> x{a};
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.A || !a.has_bid[i]) return;
  const int c = a.bid_c[i];
  const int l = c - a.lo;
  if (l < 0 || l >= a.S) return;
  // the node's lowest bidder does the node's work
  for (int j = 0; j < i; ++j) {
    if (a.has_bid[j] && a.bid_c[j] == c) return;
  }
  const T* ask = x.t(a.ask);
  T s0 = T(0), s1 = T(0), s2 = T(0);
  bool any = false;
  for (int j = i; j < a.A; ++j) {
    if (a.accepted[j] && a.bid_c[j] == c) {
      s0 = s0 + ask[3 * j];
      s1 = s1 + ask[3 * j + 1];
      s2 = s2 + ask[3 * j + 2];
      any = true;
    }
  }
  T* free = x.w(a.free_l) + 3 * l;
  if (any) {
    free[0] = free[0] - s0;
    free[1] = free[1] - s1;
    free[2] = free[2] - s2;
  }
  x.w(a.price_l)[l] = x.t(a.price_l)[l] + static_cast<T>(0.01);
}

template <typename T>
__global__ void k_epi_read(StormShardedArgs a) {
  const V<T> x{a};
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= a.A) return;
  const int g = min(max(a.assigned[r], 0), a.C - 1);
  const int l = g - a.lo;
  x.w(a.score_term)[r] = (l >= 0 && l < a.S)
      ? x.t(a.scores_l)[static_cast<size_t>(r) * a.S + l] : T(0);
}

template <typename T>
__global__ void k_finish(StormShardedArgs a) {
  const V<T> x{a};
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r == 0) a.out_rounds[0] = a.rnd;
  if (r >= a.A) return;
  const int asg = a.assigned[r];
  const bool solved = asg >= 0;
  const bool kept_walk = solved && asg == a.rows0[r];
  a.out_pulls[r] = kept_walk ? a.pulls0[r] : a.n_cand[a.eval_of[r]];
  x.w(a.out_score)[r] = solved ? x.t(a.score_read)[r] : T(0);
}

// ---- the cooperative solve (every shard in this process, one card) ----

template <typename T>
struct TableShards {
  const StormShardedArgs* sh;
  __device__ storm::ShardView<T> view(int s) const {
    const StormShardedArgs& a = sh[s];
    return {static_cast<const T*>(a.scores_l), a.feas_l,
            static_cast<T*>(a.free_l), static_cast<T*>(a.price_l)};
  }
};

// The rounds and the epilogue after the score stages, the gather and the
// walk: free capacity and prices are the score stage's, the warm start
// and assigned = -1 the walk's.
template <typename T>
__global__ void __launch_bounds__(storm::kThreads, 1)
    k_auction_coop(const __grid_constant__ StormCoopParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const StormShardedArgs& a = p.table.sh[0];
  storm::Round<T> r;
  r.ask = static_cast<const T*>(a.ask);
  r.real = a.real;
  r.rows0 = a.rows0;
  r.pulls0 = a.pulls0;
  r.n_cand = a.n_cand;
  r.eval_of = a.eval_of;
  r.assigned = a.assigned;
  r.acc_round = a.acc_round;
  r.progress = a.progress;
  r.out_pulls = a.out_pulls;
  r.out_score = static_cast<T*>(a.out_score);
  r.out_rounds = a.out_rounds;
  r.round = p.round;
  r.stamps = a.stamps;
  r.A = a.A;
  r.C = a.C;
  r.S = a.S;
  r.D = p.table.D;
  r.max_rounds = a.max_rounds;
  storm::run_auction<T>(r, TableShards<T>{p.table.sh}, smem);
}

template <typename T>
cudaError_t launch_coop(StormCoopLaunch& L, cudaStream_t s) {
  const int A = L.params.table.sh[0].A;
  const void* kern = reinterpret_cast<const void*>(k_auction_coop<T>);
  const size_t smem = storm::smem_bytes(A, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, k_auction_coop<T>, storm::kThreads, smem);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, L.device);
  if (err != cudaSuccess) return err;
  const int blocks = min(L.max_blocks > 0 ? L.max_blocks : per_sm * sms,
                         storm::kMaxGrid);
  if (blocks < 1) return cudaErrorCooperativeLaunchTooLarge;
  L.blocks = blocks;
  void* kargs[] = {&L.params};
  err = cudaLaunchCooperativeKernel(kern, dim3(blocks), dim3(storm::kThreads),
                                    kargs, smem, s);
  // a refused launch also sets the runtime's last error: clear it, or
  // the next launch's check would report it again
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

template <typename T>
cudaError_t launch(const StormShardedArgs& a, cudaStream_t s) {
  const int row_blocks = (a.A + kRowThreads - 1) / kRowThreads;
  switch (a.stage) {
    case kScore: {
      const dim3 grid((a.S + kScoreThreads - 1) / kScoreThreads, a.A);
      if (a.policy_tput != nullptr) {
        k_score<T, true><<<grid, kScoreThreads, 0, s>>>(a);
      } else {
        k_score<T, false><<<grid, kScoreThreads, 0, s>>>(a);
      }
      break;
    }
    case kWalk:
      k_walk<T><<<a.A, nk::kThreads, 0, s>>>(a);
      break;
    case kBid:
      k_bid<T><<<a.A, kBidThreads, 0, s>>>(a);
      break;
    case kCand:
      k_cand<T><<<row_blocks, kRowThreads, 0, s>>>(a);
      break;
    case kRead:
      k_read<T><<<row_blocks, kRowThreads, 0, s>>>(a);
      break;
    case kBids:
      k_bids<T><<<row_blocks, kRowThreads, 0, s>>>(a);
      break;
    case kBudget:
      k_budget<T><<<row_blocks, kRowThreads, 0, s>>>(a);
      break;
    case kAccept:
      k_accept<T><<<row_blocks, kRowThreads, 0, s>>>(a);
      break;
    case kDebit:
      k_debit<T><<<row_blocks, kRowThreads, 0, s>>>(a);
      break;
    case kEpiRead:
      k_epi_read<T><<<row_blocks, kRowThreads, 0, s>>>(a);
      break;
    case kFinish:
      k_finish<T><<<row_blocks, kRowThreads, 0, s>>>(a);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int nk_storm_sharded(const StormShardedArgs* a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = a->is_f64 ? launch<double>(*a, s)
                                    : launch<float>(*a, s);
  return static_cast<int>(err);
}

extern "C" int nk_storm_coop(StormCoopLaunch* L, void* stream) {
  if (L->params.table.D < 1 || L->params.table.D > kMaxCoopShards) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(L->device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = L->is_f64 ? launch_coop<double>(*L, s) : launch_coop<float>(*L, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Bytes of a cooperative solve's round scratch (StormCoopParams.round).
extern "C" long long nk_storm_coop_round_bytes(int A, int C, int D,
                                               int is_f64) {
  return static_cast<long long>(storm::scratch_bytes(
      A, C, D, is_f64 ? sizeof(double) : sizeof(float)));
}

// sizeof the argument block and of the cooperative launch, which the
// ctypes mirrors must match.
extern "C" int nk_storm_sharded_args_size() {
  return static_cast<int>(sizeof(StormShardedArgs));
}

extern "C" int nk_storm_coop_launch_size() {
  return static_cast<int>(sizeof(StormCoopLaunch));
}

extern "C" int nk_set_device(int device) {
  return static_cast<int>(cudaSetDevice(device));
}

extern "C" const char* nk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
