// Kernel K12: the node-sharded chained planner.  Two launch paths share
// one set of stage bodies (the __device__ functions below):
//
//   * a mesh whose shards all live in this process on one card (a
//     VirtualMesh of up to kMaxCoopShards = 32 shards): ONE
//     cooperative launch a chain
//     (k_chain_coop), the exchanges kept in device memory and each
//     phase boundary a grid.sync();
//   * a mesh whose exchanges cross processes (a DistMesh): one launch
//     per stage and shard (nk_sharded_chain), with the mesh's
//     collectives between them (nomad_tpu_torch/parallel/mesh.py
//     _drive).
//
// Replaces the JAX program nomad_tpu/parallel/mesh.py:484
// sharded_chained_plan with its walk _sharded_walk (:329), single
// group, no ports or devices.  Plain twin: parallel/mesh.py
// _TwinStages (the same stages in torch, on the same mesh).
//
// The stages, in the order the driver launches them:
//   begin     (per process) offset, dead flag and spread carries of the
//             eval reset from its inputs;
//   prologue  (per shard) the eval's collision column copied, its
//             pre-deltas added (one thread, in row order), and the
//             value-slot one-hots of its evictions written for the rows
//             this shard owns (psum-reduced by the mesh);
//   score     (per shard, one thread per node) the pick's eviction added
//             at the owner's row, then every node scored (walk.cuh
//             score_node, the same rounding and explicit fma as K3) with
//             feasibility, collisions, distinct_hosts, penalty rows,
//             affinity and the spread boost; writes final_l and feas_l
//             (all-gathered by the mesh);
//   walk_bad  (per shard, one block) the shard's slice of the eval's
//             permutation: the "bad" flag (feasible, score <= 0), its
//             local count and its count at the walk offset;
//   walk_nd   (per shard, one block) after the bad carries come back:
//             the first kMaxSkip bad positions in walk order diverted,
//             and the non-diverted and diverted counts;
//   walk_fin  (per shard, one block) after those carries: emit order,
//             the shard's best (score, emit order, position), the walk
//             position of the limit-th non-diverted node, any emission;
//   commit    (per shard) the pick's winner from the gathered records
//             (pmax of the score, pmin of the order key among the shards
//             holding it, pmin of their positions), the owner-only add
//             of its ask, and its value-slot one-hot (psum-reduced);
//   advance   (per process) rows, pulls, dead flag, offset (mod
//             n_candidates) and the spread carries.
//
// Every exchange is exact (gathers, int32 prefix sums, a max and min of
// the scores, a psum of 0/1 one-hots), so the result depends on neither
// the mesh's backend nor the order of the shards.  The usage carry
// follows the sharded program: an add whose row is not this shard's (or
// is not applied) adds +0 at the clipped row, as local_scatter does.
//
// The cooperative chain.  The D per-shard argument blocks are the
// launch's own parameter (a CoopTable by value, read in place through
// __grid_constant__: no device copy to stage, nothing to keep alive).
// Shard s's block points its score outputs at its slice [lo, lo + Cl)
// of the gathered [C] vectors and its walk records at row s of the
// [D, width] record tables, so the all-gathers and gathers are gone: a
// barrier publishes them.  Per eval: begin (block 0) and every shard's
// prologue over the grid; barrier; the psum of the eviction one-hots in
// shard order; barrier.  Per pick: the score phase over all blocks (each block a
// contiguous run of the C nodes, across shards); barrier; walk_bad with
// block s running shard s; barrier; walk_nd; barrier; walk_fin;
// barrier; block 0 runs every shard's commit in shard order, the psum of
// their one-hots in shard order and the advance; barrier.  The bodies,
// and with them the rounding (__fma_rn, -fmad=false) and the reduction
// order, are the staged kernels'.  The grid is as many 1,024-thread
// blocks as the card holds at once (the occupancy API), or a private
// cap; the result does not depend on it.  A launch the card cannot hold
// fails (cudaErrorCooperativeLaunchTooLarge) and the caller raises.
//
// What bounds it on an H100: per pick, each shard reads its C/D columns
// and the gathered [C] score and feasibility vectors; the walk stages
// are one block each.  Staged, launch latency dominates (5 launches per
// shard and one per process a pick); cooperative, the five grid
// barriers a pick and the walk blocks' serial scans.
//
// Launch: on the caller's stream; nothing is synchronised.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "walk.cuh"

namespace cg = cooperative_groups;

// Mirrored field for field by the ctypes Structure in ops/_cuda.py.
struct ShardedChainArgs {
  // this shard's node columns [Cl]
  const void* tot_cpu;
  const void* tot_mem;
  const void* tot_disk;
  void* use_cpu;  // the usage carry
  void* use_mem;
  void* use_disk;
  int32_t* coll;  // the eval's collision column
  // this shard's per-eval inputs
  const uint8_t* feas_in;   // [E, Cl]
  const void* aff_in;       // T [E, Cl]
  const int32_t* coll0_in;  // [E, Cl]
  const int32_t* codes_in;  // [E, S, Cl]
  // replicated per-eval inputs
  const int32_t* perm;  // [E, C]
  const void* ask_cpu;  // T [E]
  const void* ask_mem;
  const void* ask_disk;
  const int32_t* desired;  // [E]
  const int32_t* limit;
  const int32_t* wanted;
  const int32_t* n_cand;
  const uint8_t* dh;
  const int32_t* evict_rows;  // [E, P]
  const void* evict_cpu;      // T [E, P]
  const void* evict_mem;
  const void* evict_disk;
  const int32_t* evict_coll;  // [E, P]
  const int32_t* pen_rows;    // [E, P, K]
  const int32_t* pre_rows;    // [E, R]
  const void* pre_cpu;        // T [E, R]
  const void* pre_mem;
  const void* pre_disk;
  const void* sp_desired;  // T [E, S, V1]
  const void* sp_used0;
  const void* sp_prop0;
  const void* sp_clr0;
  const void* sp_weight;      // T [E, S]
  const uint8_t* sp_active;   // [E, S]
  const uint8_t* sp_even;     // [E, S] or null
  // replicated state (one copy per process)
  int32_t* off;   // [1]
  uint8_t* dead;  // [1]
  void* prop;     // T [S * V1]
  void* clr;
  const void* ev_oh;  // T [P, S * V1] psum of the prologues
  const void* oh;     // T [S * V1] psum of the commits
  int32_t* rows_out;   // [E, P]
  int32_t* pulls_out;  // [E, P]
  // gathered
  const void* final_g;     // T [C]
  const uint8_t* feas_g;   // [C]
  const int32_t* g_bad;    // [D, 2]
  const int32_t* g_nd;     // [D, 4]
  const double* g_fin;     // [D, 5]
  // this shard's outputs and scratch
  void* final_l;      // T [Cl]
  uint8_t* feas_l;    // [Cl]
  void* s_p;          // T [Cl] score at each permuted position
  uint8_t* f_p;       // [Cl] flags at each permuted position
  int32_t* rec_bad;   // [2]
  int32_t* rec_nd;    // [4]
  double* rec_fin;    // [5]
  void* oh_l;         // T [S * V1]
  void* ev_oh_l;      // T [P, S * V1]
  int E;
  int P;
  int C;
  int Cl;
  int D;
  int shard;
  int K;
  int R;
  int S;
  int V1;
  int e;
  int k;
  int stage;
  int spread_fit;
  int is_f64;
  int device;
};

// The D per-shard argument blocks of a cooperative chain, passed to the
// kernel by value: 32 blocks of 536 bytes need the large kernel
// parameters of CUDA 12.1 (up to 32,764 bytes on sm_70 and later).
constexpr int kMaxCoopShards = 32;

struct CoopTable {
  ShardedChainArgs sh[kMaxCoopShards];
  int D;
};

static_assert(sizeof(CoopTable) <= 32764,
              "CoopTable exceeds the kernel parameter limit");
#if CUDART_VERSION < 12010
#error "K12's cooperative chain needs CUDA 12.1's large kernel parameters"
#endif

namespace {

using nk::kMaxSkip;
using nk::kNoNode;
using nk::kInt32Max;
using nk::kThreads;
using nk::kFull;

enum Stage {
  kBegin = 0,
  kPrologue = 1,
  kScore = 2,
  kWalkBad = 3,
  kWalkNd = 4,
  kWalkFin = 5,
  kCommit = 6,
  kAdvance = 7,
};

constexpr uint8_t kFeas = 1;
constexpr uint8_t kBadF = 2;
constexpr uint8_t kDivF = 4;
constexpr int kScoreThreads = 256;

template <typename T>
struct A {
  const ShardedChainArgs& a;
  __device__ const T* t(const void* p) const { return static_cast<const T*>(p); }
  __device__ T* w(void* p) const { return static_cast<T*>(p); }
};

__device__ __forceinline__ int floordiv(int x, int d) {
  return x >= 0 ? x / d : -((-x + d - 1) / d);
}

// `local_scatter`: delta at local row idx when pred and the row is this
// shard's, else +0 at the clipped row; called by the thread owning the
// clipped row.
__device__ __forceinline__ int clip_row(int idx, int size) {
  return idx < 0 ? 0 : (idx >= size ? size - 1 : idx);
}

// The gathered walk_fin / walk_nd records reduced in ascending shard
// order: the pick's winner position, any emission and pulls.
struct Pick {
  int win_pos;
  int any;
  int pulls;
};

__device__ Pick reduce_fin(const ShardedChainArgs& a, int e) {
  const double* g = a.g_fin;
  double best = g[0];
  for (int d = 1; d < a.D; ++d) best = g[d * 5] > best ? g[d * 5] : best;
  double gmin = static_cast<double>(kInt32Max);
  for (int d = 0; d < a.D; ++d) {
    const double key = g[d * 5] == best ? g[d * 5 + 1]
                                        : static_cast<double>(kInt32Max);
    gmin = key < gmin ? key : gmin;
  }
  int win_pos = kInt32Max;
  int any = 0;
  int lth = kInt32Max;
  int nd_count = 0;
  for (int d = 0; d < a.D; ++d) {
    const double key = g[d * 5] == best ? g[d * 5 + 1]
                                        : static_cast<double>(kInt32Max);
    if (key == gmin) win_pos = min(win_pos, static_cast<int>(g[d * 5 + 2]));
    lth = min(lth, static_cast<int>(g[d * 5 + 3]));
    any = any | (g[d * 5 + 4] != 0.0 ? 1 : 0);
    nd_count += a.g_nd[d * 4];
  }
  const int lim = a.limit[e];
  Pick p;
  p.win_pos = win_pos;
  p.any = any;
  p.pulls = nd_count >= lim ? lth + 1 : a.n_cand[e];
  return p;
}

// ---- the stage bodies (staged kernels and the cooperative chain) ----

// begin: every thread of one block calls it.
template <typename T>
__device__ void begin_body(const ShardedChainArgs& a, int e) {
  const A<T> x{a};
  if (threadIdx.x == 0) {
    a.off[0] = 0;
    a.dead[0] = 0;
  }
  const int sv = a.S * a.V1;
  for (int i = threadIdx.x; i < sv; i += blockDim.x) {
    x.w(a.prop)[i] = x.t(a.sp_prop0)[static_cast<size_t>(e) * sv + i];
    x.w(a.clr)[i] = x.t(a.sp_clr0)[static_cast<size_t>(e) * sv + i];
  }
}

// prologue, local row j: the eval's collision column.
__device__ __forceinline__ void prologue_coll(const ShardedChainArgs& a,
                                              int e, int j) {
  a.coll[j] = a.coll0_in[static_cast<size_t>(e) * a.Cl + j];
}

// prologue, one thread: the eval's pre-deltas, in row order.
template <typename T>
__device__ void prologue_pre(const ShardedChainArgs& a, int e) {
  const A<T> x{a};
  const int Cl = a.Cl;
  const int lo = a.shard * Cl;
  T* cols[3] = {x.w(a.use_cpu), x.w(a.use_mem), x.w(a.use_disk)};
  const T* vals[3] = {x.t(a.pre_cpu), x.t(a.pre_mem), x.t(a.pre_disk)};
  for (int c = 0; c < 3; ++c) {
    for (int i = 0; i < a.R; ++i) {
      const size_t at = static_cast<size_t>(e) * a.R + i;
      const int idx = a.pre_rows[at] - lo;
      const bool ok = idx >= 0 && idx < Cl;
      const int safe = clip_row(idx, Cl);
      cols[c][safe] = cols[c][safe] + (ok ? vals[c][at] : T(0));
    }
  }
}

// prologue, entry i of the [P, S * V1] eviction one-hots.
template <typename T>
__device__ __forceinline__ void prologue_onehot(const ShardedChainArgs& a,
                                                int e, int i) {
  const A<T> x{a};
  const int Cl = a.Cl;
  const int lo = a.shard * Cl;
  const int sv = a.S * a.V1;
  const int k = i / sv;
  const int s = (i % sv) / a.V1;
  const int v = i % a.V1;
  const int erow = a.evict_rows[static_cast<size_t>(e) * a.P + k];
  const int idx = erow - lo;
  bool hit = false;
  if (erow >= 0 && idx >= 0 && idx < Cl) {
    hit = a.codes_in[(static_cast<size_t>(e) * a.S + s) * Cl + idx] == v;
  }
  x.w(a.ev_oh_l)[i] = hit ? T(1) : T(0);
}

// The spread boost of local node j: the S stanza terms in order from
// zero (twin: ops/batch.py spread_contribution), from the per-stanza
// state the block built in shared memory.
template <typename T>
__device__ __forceinline__ T spread_boost(const ShardedChainArgs& a, int e,
                                          const T* comb, const T* sl_min,
                                          const T* sl_max, const T* sl_has,
                                          int j) {
  const A<T> x{a};
  const T zero = T(0);
  const T one = T(1);
  T total = zero;
  for (int s = 0; s < a.S; ++s) {
    const int code =
        a.codes_in[(static_cast<size_t>(e) * a.S + s) * a.Cl + j];
    const T used_node = comb[s * a.V1 + code];
    const T dn =
        x.t(a.sp_desired)[(static_cast<size_t>(e) * a.S + s) * a.V1 + code];
    const T safe_d = dn != zero ? dn : one;
    const T frac = (dn - (used_node + one)) / safe_d;
    const T pct = frac * x.t(a.sp_weight)[e * a.S + s];
    const bool pen_node = code == a.V1 - 1;
    T contrib = pen_node ? -one : pct;
    if (a.sp_even != nullptr && a.sp_even[e * a.S + s]) {
      const T mn = sl_min[s];
      const T mx = sl_max[s];
      const T safe_min = mn > zero ? mn : one;
      const T delta_boost = mn == zero ? -one : (mn - used_node) / safe_min;
      T even_val;
      if (used_node != mn) {
        even_val = delta_boost;
      } else if (mn == mx) {
        even_val = -one;
      } else {
        even_val = mn == zero ? one : (mx - mn) / safe_min;
      }
      contrib = sl_has[s] != zero ? (pen_node ? -one : even_val) : zero;
    }
    contrib = a.sp_active[e * a.S + s] ? contrib : zero;
    total = total + contrib;
  }
  return total;
}

// The per-stanza spread state of pick k in shared memory: the combined
// use map (the cleared carry with the pick's evictee slot added), the
// min and max over present values.  Every thread of the block calls it;
// it depends on the process's state only, not on the shard.
template <typename T, bool kSpread>
__device__ void score_state(const ShardedChainArgs& a, int e, int k, T* comb,
                            T* sl_min, T* sl_max, T* sl_has) {
  if (!kSpread) return;
  const A<T> x{a};
  const int sv = a.S * a.V1;
  const size_t ek = static_cast<size_t>(e) * a.P + k;
  const bool active = k < a.wanted[e] && a.dead[0] == 0;
  const bool app = active && a.evict_rows[ek] >= 0;
  const T zero = T(0);
  const T one = T(1);
  const T* used0 = x.t(a.sp_used0) + static_cast<size_t>(e) * sv;
  const T* prop = x.t(a.prop);
  const T* clr = x.t(a.clr);
  const T* ev = x.t(a.ev_oh) + static_cast<size_t>(k) * sv;
  for (int i = threadIdx.x; i < sv; i += blockDim.x) {
    const T p = prop[i];
    const T c = clr[i] + (app ? ev[i] : zero);
    const T clr_adj = c - ((p > zero) && (c > one) ? one : zero);
    const T v = (used0[i] + p) - clr_adj;
    comb[i] = v > zero ? v : zero;
  }
  __syncthreads();
  for (int s = threadIdx.x; s < a.S; s += blockDim.x) {
    T mn = static_cast<T>(INFINITY);
    T mx = -static_cast<T>(INFINITY);
    bool has = false;
    for (int v = 0; v < a.V1 - 1; ++v) {
      const int i = s * a.V1 + v;
      if ((used0[i] + prop[i]) > zero) {
        has = true;
        const T c = comb[i];
        mn = c < mn ? c : mn;
        mx = c > mx ? c : mx;
      }
    }
    sl_min[s] = mn;
    sl_max[s] = mx;
    sl_has[s] = has ? one : zero;
  }
  __syncthreads();
}

// score, local node j of this shard: the pick's eviction (owner only,
// +0 at the clipped row otherwise), then the node's score and
// feasibility into final_l and feas_l.
template <typename T, bool kSpread>
__device__ __forceinline__ void score_one(const ShardedChainArgs& a, int e,
                                          int k, int j, const T* comb,
                                          const T* sl_min, const T* sl_max,
                                          const T* sl_has) {
  const A<T> x{a};
  const int Cl = a.Cl;
  const int lo = a.shard * Cl;
  const size_t ek = static_cast<size_t>(e) * a.P + k;
  const bool active = k < a.wanted[e] && a.dead[0] == 0;
  const int erow = a.evict_rows[ek];
  const bool app = active && erow >= 0;
  const T zero = T(0);
  T* use_cpu = x.w(a.use_cpu);
  T* use_mem = x.w(a.use_mem);
  T* use_disk = x.w(a.use_disk);
  T u_cpu = use_cpu[j];
  T u_mem = use_mem[j];
  T u_disk = use_disk[j];
  int coll = a.coll[j];
  // the eviction, owner only (+0 at the clipped row otherwise)
  const int eidx = erow - lo;
  if (j == clip_row(eidx, Cl)) {
    const bool ok = app && eidx >= 0 && eidx < Cl;
    u_cpu = u_cpu + (ok ? x.t(a.evict_cpu)[ek] : zero);
    u_mem = u_mem + (ok ? x.t(a.evict_mem)[ek] : zero);
    u_disk = u_disk + (ok ? x.t(a.evict_disk)[ek] : zero);
    coll = coll + (ok ? a.evict_coll[ek] : 0);
    use_cpu[j] = u_cpu;
    use_mem[j] = u_mem;
    use_disk[j] = u_disk;
    a.coll[j] = coll;
  }
  bool pen = false;
  for (int q = 0; q < a.K; ++q) {
    pen = pen || (lo + j == a.pen_rows[ek * a.K + q]);
  }
  const T cpu_total = x.t(a.tot_cpu)[j];
  const T mem_total = x.t(a.tot_mem)[j];
  const T cpu_after = u_cpu + x.t(a.ask_cpu)[e];
  const T mem_after = u_mem + x.t(a.ask_mem)[e];
  const T disk_after = u_disk + x.t(a.ask_disk)[e];
  const bool fit = (cpu_after <= cpu_total) & (mem_after <= mem_total) &
                   (disk_after <= x.t(a.tot_disk)[j]);
  const bool feas = a.feas_in[static_cast<size_t>(e) * Cl + j] != 0 && fit &&
                    !(a.dh[e] != 0 && coll > 0);
  const T aff = x.t(a.aff_in)[static_cast<size_t>(e) * Cl + j];
  const T boost = kSpread
                      ? spread_boost<T>(a, e, comb, sl_min, sl_max, sl_has, j)
                      : zero;
  const T want = static_cast<T>(a.desired[e]);
  x.w(a.final_l)[j] = nk::score_node<T, kSpread>(
      cpu_total, mem_total, cpu_after, mem_after, coll, pen, aff, boost, want,
      a.spread_fit != 0);
  a.feas_l[j] = feas ? 1 : 0;
}

// The shard's slice of the walk: thread t owns local positions
// [t * run, (t + 1) * run).
struct Run {
  int lo_j;
  int hi_j;
};

__device__ __forceinline__ Run run_of(int Cl) {
  const int run = (Cl + kThreads - 1) / kThreads;
  Run r;
  r.lo_j = min(static_cast<int>(threadIdx.x) * run, Cl);
  r.hi_j = min(r.lo_j + run, Cl);
  return r;
}

// The rotation frame of this shard and eval.
struct Frame {
  int off;
  int nc;
  int own;
  int off_local;
};

__device__ __forceinline__ Frame frame_of(const ShardedChainArgs& a, int e) {
  Frame f;
  f.off = a.off[0];
  f.nc = a.n_cand[e];
  f.own = floordiv(f.off - 1, a.Cl);
  f.off_local = (f.off - 1) - f.own * a.Cl;
  return f;
}

// `rot` of _sharded_walk from the gathered (total, count at the offset)
// records at column `col` of a [D, width] record table.
struct Rot {
  int carry;
  int total;
  int c_off;
};

__device__ __forceinline__ Rot rot_of(const int32_t* g, int width, int col,
                                      int shard, int D, const Frame& f) {
  Rot r;
  r.carry = 0;
  r.total = 0;
  int before_own = 0;
  for (int d = 0; d < D; ++d) {
    const int t = g[d * width + col];
    if (d < shard) r.carry += t;
    if (d < f.own) before_own += t;
    r.total += t;
  }
  r.c_off = 0;
  if (f.off > 0) r.c_off = g[f.own * width + col + 1] + before_own;
  return r;
}

__device__ __forceinline__ int rotated(int cs_local, const Rot& r, int pos,
                                       const Frame& f) {
  const int cs = cs_local + r.carry;
  if (pos >= f.nc) return r.total;
  return pos < f.off ? cs + (r.total - r.c_off) : cs - r.c_off;
}

// walk_bad, walk_nd, walk_fin: every thread of one kThreads block.
template <typename T>
__device__ void walk_bad_body(const ShardedChainArgs& a, int e) {
  __shared__ int smem[2 * nk::kWarps + 2];
  const A<T> x{a};
  const int Cl = a.Cl;
  const int lo = a.shard * Cl;
  const Frame f = frame_of(a, e);
  const Run r = run_of(Cl);
  const int32_t* perm = a.perm + static_cast<size_t>(e) * a.C + lo;
  T* s_p = x.w(a.s_p);
  int cnt[1] = {0};
  for (int j = r.lo_j; j < r.hi_j; ++j) {
    const int p = perm[j];
    const T s = x.t(a.final_g)[p];
    const bool fe = a.feas_g[p] != 0;
    const bool bad = fe && s <= T(0);
    s_p[j] = s;
    a.f_p[j] = (fe ? kFeas : 0) | (bad ? kBadF : 0);
    cnt[0] += bad ? 1 : 0;
  }
  int tot[1];
  nk::block_exclusive_scan<1>(cnt, tot, smem);
  if (threadIdx.x == 0) {
    a.rec_bad[0] = tot[0];
    if (f.own != a.shard) a.rec_bad[1] = 0;
  }
  if (f.own == a.shard && f.off_local >= r.lo_j && f.off_local < r.hi_j) {
    int cs = cnt[0];
    for (int j = r.lo_j; j <= f.off_local; ++j) cs += (a.f_p[j] & kBadF) ? 1 : 0;
    a.rec_bad[1] = cs;
  }
}

template <typename T>
__device__ void walk_nd_body(const ShardedChainArgs& a, int e) {
  __shared__ int smem[2 * nk::kWarps + 2];
  const int Cl = a.Cl;
  const int lo = a.shard * Cl;
  const Frame f = frame_of(a, e);
  const Run r = run_of(Cl);
  const Rot rb = rot_of(a.g_bad, 2, 0, a.shard, a.D, f);
  int cnt[1] = {0};
  for (int j = r.lo_j; j < r.hi_j; ++j) cnt[0] += (a.f_p[j] & kBadF) ? 1 : 0;
  int bad_tot[1];
  nk::block_exclusive_scan<1>(cnt, bad_tot, smem);
  int bad_cs = cnt[0];
  int nd_div[2] = {0, 0};
  for (int j = r.lo_j; j < r.hi_j; ++j) {
    uint8_t fl = a.f_p[j];
    if (fl & kBadF) {
      ++bad_cs;
      if (rotated(bad_cs, rb, lo + j, f) <= kMaxSkip) {
        fl |= kDivF;
        a.f_p[j] = fl;
      }
    }
    const bool div = (fl & kDivF) != 0;
    nd_div[0] += ((fl & kFeas) && !div) ? 1 : 0;
    nd_div[1] += div ? 1 : 0;
  }
  int tot[2];
  int ex[2] = {nd_div[0], nd_div[1]};
  nk::block_exclusive_scan<2>(ex, tot, smem);
  if (threadIdx.x == 0) {
    a.rec_nd[0] = tot[0];
    a.rec_nd[2] = tot[1];
    if (f.own != a.shard) {
      a.rec_nd[1] = 0;
      a.rec_nd[3] = 0;
    }
  }
  if (f.own == a.shard && f.off_local >= r.lo_j && f.off_local < r.hi_j) {
    int nd = ex[0];
    int dv = ex[1];
    for (int j = r.lo_j; j <= f.off_local; ++j) {
      const uint8_t fl = a.f_p[j];
      const bool div = (fl & kDivF) != 0;
      nd += ((fl & kFeas) && !div) ? 1 : 0;
      dv += div ? 1 : 0;
    }
    a.rec_nd[1] = nd;
    a.rec_nd[3] = dv;
  }
}

template <typename T>
__device__ void walk_fin_body(const ShardedChainArgs& a, int e) {
  __shared__ int smem[2 * nk::kWarps + 2];
  const A<T> x{a};
  const int Cl = a.Cl;
  const int lo = a.shard * Cl;
  const Frame f = frame_of(a, e);
  const Run r = run_of(Cl);
  const Rot rn = rot_of(a.g_nd, 4, 0, a.shard, a.D, f);
  const Rot rd = rot_of(a.g_nd, 4, 2, a.shard, a.D, f);
  const int nd_count = rn.total;
  const int n_div = rd.total;
  const bool reverse = (n_div == 2) && (nd_count > 0);
  const int lim = a.limit[e];
  int c2[2] = {0, 0};
  for (int j = r.lo_j; j < r.hi_j; ++j) {
    const uint8_t fl = a.f_p[j];
    const bool div = (fl & kDivF) != 0;
    c2[0] += ((fl & kFeas) && !div) ? 1 : 0;
    c2[1] += div ? 1 : 0;
  }
  int tot[2];
  nk::block_exclusive_scan<2>(c2, tot, smem);
  int nd_cs = c2[0];
  int div_cs = c2[1];
  T best_s = -static_cast<T>(INFINITY);
  int best_ord = kInt32Max;
  int best_j = -1;
  int lth = kInt32Max;
  int any = 0;
  const T* s_p = x.t(a.s_p);
  for (int j = r.lo_j; j < r.hi_j; ++j) {
    const uint8_t fl = a.f_p[j];
    const bool fe = (fl & kFeas) != 0;
    const bool div = (fl & kDivF) != 0;
    const bool nd = fe && !div;
    nd_cs += nd ? 1 : 0;
    div_cs += div ? 1 : 0;
    const int pos = lo + j;
    const int nd_incl = rotated(nd_cs, rn, pos, f);
    const int div_incl = rotated(div_cs, rd, pos, f);
    const int div_rank = div_incl - 1;
    const int div_order = reverse ? 1 - div_rank : div_rank;
    const int ord = nd ? nd_incl - 1 : nd_count + div_order;
    if (fe && ord < lim) {
      any = 1;
      const T s = s_p[j];
      if (nk::better(s, ord, best_s, best_ord)) {
        best_s = s;
        best_ord = ord;
        best_j = j;
      }
    }
    if (nd && nd_incl == lim) {
      const int wp = pos >= f.nc ? pos : ((pos - f.off + f.nc) % f.nc);
      lth = min(lth, wp);
    }
  }
  any = __syncthreads_or(any);
  nk::Best<T> v;
  v.s = best_s;
  v.ord = best_ord;
  v.w = best_j;
  v.lth = lth;
  v = nk::block_best<T>(v);
  if (threadIdx.x == 0) {
    a.rec_fin[0] = static_cast<double>(v.s);
    a.rec_fin[1] = static_cast<double>(v.ord);
    // no candidate: the first position, as argmin over all-big keys
    a.rec_fin[2] = static_cast<double>(lo + (v.ord == kInt32Max ? 0 : v.w));
    a.rec_fin[3] = static_cast<double>(v.lth);
    a.rec_fin[4] = any ? 1.0 : 0.0;
  }
}

// commit: every thread of one block.
template <typename T>
__device__ void commit_body(const ShardedChainArgs& a, int e, int k) {
  const A<T> x{a};
  const int Cl = a.Cl;
  const int lo = a.shard * Cl;
  const Pick p = reduce_fin(a, e);
  const bool active = k < a.wanted[e] && a.dead[0] == 0;
  const bool ok = active && p.any;
  const int row = ok ? a.perm[static_cast<size_t>(e) * a.C + p.win_pos] : kNoNode;
  const int idx = row - lo;
  const bool mine = ok && idx >= 0 && idx < Cl;
  if (threadIdx.x == 0) {
    const int safe = clip_row(idx, Cl);
    T* cols[3] = {x.w(a.use_cpu), x.w(a.use_mem), x.w(a.use_disk)};
    const T* asks[3] = {x.t(a.ask_cpu), x.t(a.ask_mem), x.t(a.ask_disk)};
    for (int c = 0; c < 3; ++c) {
      cols[c][safe] = cols[c][safe] + (mine ? asks[c][e] : T(0));
    }
    a.coll[safe] = a.coll[safe] + (mine ? 1 : 0);
  }
  const int sv = a.S * a.V1;
  for (int i = threadIdx.x; i < sv; i += blockDim.x) {
    const int s = i / a.V1;
    const int v = i % a.V1;
    const bool hit =
        mine && a.codes_in[(static_cast<size_t>(e) * a.S + s) * Cl + idx] == v;
    x.w(a.oh_l)[i] = hit ? T(1) : T(0);
  }
}

// advance: every thread of one block.
template <typename T>
__device__ void advance_body(const ShardedChainArgs& a, int e, int k) {
  const A<T> x{a};
  const Pick p = reduce_fin(a, e);
  const bool active = k < a.wanted[e] && a.dead[0] == 0;
  const bool app = active && a.evict_rows[static_cast<size_t>(e) * a.P + k] >= 0;
  const bool ok = active && p.any;
  const int off = a.off[0];
  __syncthreads();  // every thread has read dead and off
  const int sv = a.S * a.V1;
  const T* ev = x.t(a.ev_oh) + static_cast<size_t>(k) * sv;
  for (int i = threadIdx.x; i < sv; i += blockDim.x) {
    x.w(a.clr)[i] = x.t(a.clr)[i] + (app ? ev[i] : T(0));
    x.w(a.prop)[i] = x.t(a.prop)[i] + x.t(a.oh)[i];
  }
  if (threadIdx.x == 0) {
    const size_t ek = static_cast<size_t>(e) * a.P + k;
    a.rows_out[ek] = ok ? a.perm[static_cast<size_t>(e) * a.C + p.win_pos] : kNoNode;
    a.pulls_out[ek] = active ? p.pulls : 0;
    if (active && !p.any) a.dead[0] = 1;
    const int nc = a.n_cand[e];
    const int next = off + (active ? p.pulls : 0);
    a.off[0] = ((next % nc) + nc) % nc;
  }
}

// ---- the staged kernels (a mesh whose exchanges cross processes) ----

template <typename T>
__global__ void k_begin(ShardedChainArgs a) {
  begin_body<T>(a, a.e);
}

template <typename T>
__global__ void k_prologue(ShardedChainArgs a) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < a.Cl) prologue_coll(a, a.e, j);
  if (blockIdx.x == 0 && threadIdx.x == 0) prologue_pre<T>(a, a.e);
  const int n = a.P * a.S * a.V1;
  for (int i = j; i < n; i += gridDim.x * blockDim.x) {
    prologue_onehot<T>(a, a.e, i);
  }
}

template <typename T>
struct SpreadSmem {
  T* comb;
  T* sl_min;
  T* sl_max;
  T* sl_has;
};

// The spread state's shared memory: [S * V1] combined map, then the
// per-stanza min, max and presence.
template <typename T>
__device__ __forceinline__ SpreadSmem<T> spread_smem(unsigned char* raw,
                                                     int S, int V1) {
  SpreadSmem<T> m;
  m.comb = reinterpret_cast<T*>(raw);
  m.sl_min = m.comb + S * V1;
  m.sl_max = m.sl_min + S;
  m.sl_has = m.sl_max + S;
  return m;
}

template <typename T, bool kSpread>
__global__ void k_score(ShardedChainArgs a) {
  extern __shared__ unsigned char smem_raw[];
  const SpreadSmem<T> m = spread_smem<T>(smem_raw, a.S, a.V1);
  score_state<T, kSpread>(a, a.e, a.k, m.comb, m.sl_min, m.sl_max, m.sl_has);
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= a.Cl) return;
  score_one<T, kSpread>(a, a.e, a.k, j, m.comb, m.sl_min, m.sl_max, m.sl_has);
}

template <typename T>
__global__ void k_walk_bad(ShardedChainArgs a) {
  walk_bad_body<T>(a, a.e);
}

template <typename T>
__global__ void k_walk_nd(ShardedChainArgs a) {
  walk_nd_body<T>(a, a.e);
}

template <typename T>
__global__ void k_walk_fin(ShardedChainArgs a) {
  walk_fin_body<T>(a, a.e);
}

template <typename T>
__global__ void k_commit(ShardedChainArgs a) {
  commit_body<T>(a, a.e, a.k);
}

template <typename T>
__global__ void k_advance(ShardedChainArgs a) {
  advance_body<T>(a, a.e, a.k);
}

template <typename T>
cudaError_t launch(const ShardedChainArgs& a, cudaStream_t s) {
  const int blocks = (a.Cl + kScoreThreads - 1) / kScoreThreads;
  switch (a.stage) {
    case kBegin:
      k_begin<T><<<1, 256, 0, s>>>(a);
      break;
    case kPrologue:
      k_prologue<T><<<blocks, kScoreThreads, 0, s>>>(a);
      break;
    case kScore: {
      const size_t smem = sizeof(T) * (a.S * a.V1 + 3 * a.S);
      if (a.S > 0) {
        k_score<T, true><<<blocks, kScoreThreads, smem, s>>>(a);
      } else {
        k_score<T, false><<<blocks, kScoreThreads, 0, s>>>(a);
      }
      break;
    }
    case kWalkBad:
      k_walk_bad<T><<<1, kThreads, 0, s>>>(a);
      break;
    case kWalkNd:
      k_walk_nd<T><<<1, kThreads, 0, s>>>(a);
      break;
    case kWalkFin:
      k_walk_fin<T><<<1, kThreads, 0, s>>>(a);
      break;
    case kCommit:
      k_commit<T><<<1, 128, 0, s>>>(a);
      break;
    case kAdvance:
      k_advance<T><<<1, 128, 0, s>>>(a);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// ---- the cooperative chain (every shard in this process, one card) ----

// The psum of D per-shard one-hot vectors, entry i, added in ascending
// shard order from shard 0's value (VirtualMesh.psum).
template <typename T>
__device__ __forceinline__ T psum_at(const ShardedChainArgs* sh, int D,
                                     void* ShardedChainArgs::*field,
                                     int i) {
  T acc = static_cast<const T*>(sh[0].*field)[i];
  for (int d = 1; d < D; ++d) acc = acc + static_cast<const T*>(sh[d].*field)[i];
  return acc;
}

template <typename T, bool kSpread>
__global__ void __launch_bounds__(kThreads, 1)
    k_chain_coop(const __grid_constant__ CoopTable t) {
  cg::grid_group grid = cg::this_grid();
  const ShardedChainArgs* sh = t.sh;
  const int D = t.D;
  extern __shared__ unsigned char smem_raw[];
  const ShardedChainArgs& a0 = sh[0];
  const SpreadSmem<T> m = spread_smem<T>(smem_raw, a0.S, a0.V1);
  const int E = a0.E;
  const int P = a0.P;
  const int C = a0.C;
  const int Cl = a0.Cl;
  const int sv = a0.S * a0.V1;
  const int tid = threadIdx.x;
  const int gtid = blockIdx.x * blockDim.x + tid;
  const int gsize = gridDim.x * blockDim.x;
  // the score phase's nodes: block b scores [b * chunk, (b + 1) * chunk)
  // of the C nodes, shard after shard
  const int chunk = (C + gridDim.x - 1) / gridDim.x;
  const int g_lo = min(static_cast<int>(blockIdx.x) * chunk, C);
  const int g_hi = min(g_lo + chunk, C);
  const int n_oh = P * sv;
  for (int e = 0; e < E; ++e) {
    if (blockIdx.x == 0) begin_body<T>(a0, e);
    for (int g = gtid; g < C; g += gsize) {
      const int s = g / Cl;
      prologue_coll(sh[s], e, g - s * Cl);
    }
    if (gtid < D) prologue_pre<T>(sh[gtid], e);
    for (int i = gtid; i < D * n_oh; i += gsize) {
      const int s = i / n_oh;
      prologue_onehot<T>(sh[s], e, i - s * n_oh);
    }
    grid.sync();
    if (n_oh > 0) {
      // written by the mesh's psums when staged, by the grid here
      T* ev_oh = static_cast<T*>(const_cast<void*>(a0.ev_oh));
      for (int i = gtid; i < n_oh; i += gsize) {
        ev_oh[i] = psum_at<T>(sh, D, &ShardedChainArgs::ev_oh_l, i);
      }
      grid.sync();
    }
    for (int k = 0; k < P; ++k) {
      if (g_lo < g_hi) {  // block-uniform
        score_state<T, kSpread>(a0, e, k, m.comb, m.sl_min, m.sl_max,
                                m.sl_has);
        for (int g = g_lo + tid; g < g_hi; g += blockDim.x) {
          const int s = g / Cl;
          score_one<T, kSpread>(sh[s], e, k, g - s * Cl, m.comb, m.sl_min,
                                m.sl_max, m.sl_has);
        }
      }
      grid.sync();
      for (int s = blockIdx.x; s < D; s += gridDim.x) walk_bad_body<T>(sh[s], e);
      grid.sync();
      for (int s = blockIdx.x; s < D; s += gridDim.x) walk_nd_body<T>(sh[s], e);
      grid.sync();
      for (int s = blockIdx.x; s < D; s += gridDim.x) walk_fin_body<T>(sh[s], e);
      grid.sync();
      if (blockIdx.x == 0) {
        for (int s = 0; s < D; ++s) commit_body<T>(sh[s], e, k);
        __syncthreads();
        T* oh = static_cast<T*>(const_cast<void*>(a0.oh));
        for (int i = tid; i < sv; i += blockDim.x) {
          oh[i] = psum_at<T>(sh, D, &ShardedChainArgs::oh_l, i);
        }
        __syncthreads();
        advance_body<T>(a0, e, k);
      }
      grid.sync();
    }
  }
}

}  // namespace

// The cooperative launch of one chain: the table of its D per-shard
// argument blocks and the launch's settings.  Mirrored by the ctypes
// Structure in ops/_cuda.py.
struct ShardedCoopLaunch {
  CoopTable table;  // passed to the kernel by value
  int S;
  int V1;
  int is_f64;
  int device;
  int max_blocks;  // 0: as many blocks as the card holds at once
  int blocks;      // out: the grid launched
};

namespace {

template <typename T, bool kSpread>
cudaError_t launch_coop(ShardedCoopLaunch& L, cudaStream_t s) {
  const void* kern = reinterpret_cast<const void*>(k_chain_coop<T, kSpread>);
  const size_t smem = kSpread ? sizeof(T) * (L.S * L.V1 + 3 * L.S) : 0;
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, k_chain_coop<T, kSpread>, kThreads, smem);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, L.device);
  if (err != cudaSuccess) return err;
  const int blocks = L.max_blocks > 0 ? L.max_blocks : per_sm * sms;
  if (blocks < 1) return cudaErrorCooperativeLaunchTooLarge;
  L.blocks = blocks;
  void* kargs[] = {&L.table};
  err = cudaLaunchCooperativeKernel(kern, dim3(blocks), dim3(kThreads), kargs,
                                    smem, s);
  // a refused launch also sets the runtime's last error: clear it, or
  // the next launch's check would report it again
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

}  // namespace

extern "C" int nk_sharded_chain(const ShardedChainArgs* a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = a->is_f64 ? launch<double>(*a, s)
                                    : launch<float>(*a, s);
  return static_cast<int>(err);
}

extern "C" int nk_sharded_chain_coop(ShardedCoopLaunch* L, void* stream) {
  if (L->table.D < 1 || L->table.D > kMaxCoopShards) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(L->device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool spread = L->S > 0;
  if (L->is_f64) {
    err = spread ? launch_coop<double, true>(*L, s)
                 : launch_coop<double, false>(*L, s);
  } else {
    err = spread ? launch_coop<float, true>(*L, s)
                 : launch_coop<float, false>(*L, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// sizeof the argument block and of the cooperative launch, which the
// ctypes mirrors must match.
extern "C" int nk_sharded_chain_args_size() {
  return static_cast<int>(sizeof(ShardedChainArgs));
}

extern "C" int nk_sharded_coop_launch_size() {
  return static_cast<int>(sizeof(ShardedCoopLaunch));
}

extern "C" int nk_set_device(int device) {
  return static_cast<int>(cudaSetDevice(device));
}

extern "C" const char* nk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
