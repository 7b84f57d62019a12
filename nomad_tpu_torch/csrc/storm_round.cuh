// The storm auction's rounds as one cooperative launch, shared by K5
// (csrc/storm_solve.cu: the arena as one shard) and K14
// (csrc/storm_sharded.cu: D node shards of a VirtualMesh on one card).
// One round of the JAX program's `body` (nomad_tpu/ops/solve.py:206-283)
// is two phases between grid barriers:
//
//   B   (the grid) each row still bidding scans its nodes: the argmax
//       of value + jitter (first node on ties) over ok nodes, value =
//       score - price where the node is feasible and its free capacity
//       fits the row's ask, else -inf.  A warp takes a (row, chunk) item,
//       a chunk a slice of one shard's nodes: one chunk a shard while the
//       (row, shard) pairs fill the grid's warps, more as the rows thin
//       out, so the late rounds' few rows still spread over the card, and
//       no block barrier is needed.  Each item writes its best (value +
//       jitter, value, node); in round 0 the row's first item also reads
//       the value at the row's walk winner.
//   RD  (block 0, the other blocks wait at the next barrier) in shared
//       memory: each row's bid from its items' bests (reduced by (value
//       + jitter descending, node ascending): the mesh's pmax, then pmin
//       of the ids at the max) and, in round 0, the walk winner when it
//       still fits; the bidders compacted in ascending row order (a block
//       prefix sum) and sorted by (node, value descending, row) (a
//       bitonic sort of 128-bit keys), so a node's bidders are one
//       segment in rank order (value descending, ties to the lower row):
//       a bidder's rank is its place in its segment.  Per segment the
//       largest bidder ask per dimension (a thread a segment of up to 32
//       bidders, a warp a larger one) and m = min_d floor(free /
//       max(maxask, 1e-9)) over dimensions with maxask > 0, from the
//       node's free capacity at the round's start; acceptance iff rank
//       == 0 || rank < m; price += 0.01 on every node with a bidder.
//       The debit: the accepted rows compacted in ascending row order and
//       sorted by (node, row), each node's asks summed in that order by
//       one thread and subtracted once.  Then the round's progress flag
//       and the next round's bidders: the rows that bid and were not
//       accepted.
//
// A row that makes no bid has no ok node, and never will: prices only
// rise and free capacity only falls.  It leaves the list of bidding
// rows and is scanned no more (it still counts as "no bid").  Values
// read at a node go through the owner: the owner's value plus +0.0 from
// every other shard in shard order (VirtualMesh.psum), so a -0.0 reads
// +0.0 at D > 1, as the sharded JAX program reads it.
//
// Block 0's arrays live in shared memory up to kSmemRows bidding rows
// (the storm path's cap, MAX_STORM_ROWS) and in the round scratch in
// device memory above it: the same code over other storage.
//
// Memory: every array one block writes and another reads (free capacity,
// prices, the lists of bidding rows, the items' bests, the walk reads,
// the state) is read with plain loads after the grid barrier that
// publishes it, never through __ldg or a __restrict__ pointer; the
// feasibility mask, the scores, the asks and the warm start, written
// before the launch, go through the read-only path.
//
// Exactness: the twins' and the JAX programs' order: max and min are
// exact in any order, the rank is a count, the debit adds in ascending
// row order; the budget's floor and division are IEEE (-prec-div=true).

#pragma once

#include <cooperative_groups.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "walk.cuh"

namespace storm {

namespace cg = cooperative_groups;

constexpr int kThreads = 1024;  // the cooperative auction's blocks
constexpr int kSmemRows = 1024;  // block 0's arrays in shared memory
constexpr int kMaxGrid = 1024;   // the most blocks an auction launches
constexpr int kMaxSub = 64;      // the most phase-B items a row
constexpr int kStampsPerRound = 2;
constexpr uint32_t kJitterRow = 0x9E3779B9u;  // int32 -1640531527
constexpr uint32_t kJitterNode = 40503u;
constexpr unsigned long long kNoKey = ~0ull;

// %globaltimer (ns) into `at`.  A stamp buffer holds: [0] the stamps a
// round, [1]-[3] the score, walk and auction kernels' starts, [4] the
// auction's set-up barrier, then the round barriers.
__device__ __forceinline__ void stamp(long long* at) {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  *at = t;
}

// (row * -1640531527 + node * 40503) & 0xFFFF with int32 wraparound,
// in uint32 (the same low 16 bits), scaled to [0, 1e-6)
template <typename T>
__device__ __forceinline__ T jitter(int a, int c) {
  const uint32_t h = (static_cast<uint32_t>(a) * kJitterRow +
                      static_cast<uint32_t>(c) * kJitterNode) & 0xFFFFu;
  return static_cast<T>(h) / T(65536) * static_cast<T>(1e-6);
}

// bid key: larger value + jitter first, then the lower node id
template <typename T>
__device__ __forceinline__ bool bid_better(T vj, int c, T bvj, int bc) {
  return vj > bvj || (vj == bvj && c < bc);
}

// m = min_d floor(free_d / max(maxask_d, 1e-9)) over the dimensions with
// maxask_d > 0; +inf without one
template <typename T>
__device__ __forceinline__ T budget(T f0, T f1, T f2, T mx0, T mx1, T mx2) {
  const T tiny = static_cast<T>(1e-9);
  const T f[3] = {f0, f1, f2};
  const T mx[3] = {mx0, mx1, mx2};
  T m = T(INFINITY);
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    if (mx[d] > T(0)) {
      const T q = floor(f[d] / (mx[d] > tiny ? mx[d] : tiny));
      m = q < m ? q : m;
    }
  }
  return m;
}

// The psum over D shards of one owner's term, +0.0 from every other
// shard, added in shard order from shard 0's (VirtualMesh.psum).
template <typename T>
__device__ __forceinline__ T owner_psum(T v, int owner, int D) {
  T acc = owner == 0 ? v : T(0);
  for (int d = 1; d < D; ++d) acc = acc + (d == owner ? v : T(0));
  return acc;
}

// One shard's node-indexed inputs: the scores and feasibility the rounds
// read, the free capacity and prices they start from (copied into the
// round scratch's node state, which the rounds update).
template <typename T>
struct ShardView {
  const T* scores;       // [A, S]
  const uint8_t* feas;   // [A, S]
  const T* free;         // [S, 3]
  const T* price;        // [S]
};

// The rounds' node state by global node id: four values a node (free
// capacity in three dimensions, then the price), one 32-byte (f64) or
// 16-byte (f32) record, read with vector loads.
template <typename T>
struct Nodes {
  T* v;  // [C, 4]
  __device__ T& f(int g, int d) const { return v[4 * static_cast<size_t>(g) + d]; }
  __device__ T& price(int g) const { return v[4 * static_cast<size_t>(g) + 3]; }
};

__device__ __forceinline__ void load_node(const double* v, int g, double& f0,
                                          double& f1, double& f2,
                                          double& price) {
  const double2 a = reinterpret_cast<const double2*>(v)[2 * g];
  const double2 b = reinterpret_cast<const double2*>(v)[2 * g + 1];
  f0 = a.x;
  f1 = a.y;
  f2 = b.x;
  price = b.y;
}

__device__ __forceinline__ void load_node(const float* v, int g, float& f0,
                                          float& f1, float& f2, float& price) {
  const float4 a = reinterpret_cast<const float4*>(v)[g];
  f0 = a.x;
  f1 = a.y;
  f2 = a.z;
  price = a.w;
}

// The solve's replicated inputs, state and outputs.
template <typename T>
struct Round {
  const T* ask;            // [A, 3], read-only for the whole solve
  const uint8_t* real;     // [A]
  const int32_t* rows0;    // [A] the warm start
  const int32_t* pulls0;   // [A]
  const int32_t* n_cand;   // [E]
  const int32_t* eval_of;  // [A]
  int32_t* assigned;       // [A]
  int32_t* acc_round;      // [A]
  int32_t* progress;       // [max(1, max_rounds)]
  int32_t* out_pulls;      // [A]
  T* out_score;            // [A]
  int32_t* out_rounds;     // [1]
  void* round;             // the round scratch (scratch_bytes)
  long long* stamps;       // or null
  int A, C, S, D, max_rounds;
};

__host__ __device__ constexpr size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

__host__ __device__ inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Block 0's arrays for up to `cap` bidding rows: by a row's index i in
// the round's list of bidding rows (ask, bv, row, bc, flag), by sorted
// position q (khi/klo, the (node, value, i) keys, then the accepted
// rows' (node, i) keys in khi; seg), by segment (start, tau).
template <typename T>
struct Work {
  T* ask;                    // [cap, 3] the bidding row's ask
  T* bv;                     // [cap] the bid's value
  int* row;                  // [cap] the bidding row
  int* bc;                   // [cap] the bid's node
  int* flag;                 // [cap] 1 bid, 3 bid and accepted, 0 none
  int* seg;                  // [cap] a position's segment
  unsigned long long* khi;   // [pow2(cap)] sort keys, high words
  unsigned long long* klo;   // [pow2(cap)] low words
  int* start;                // [cap + 1] a segment's first position
  int* tau;                  // [cap] a segment's acceptance bound
};

__host__ __device__ inline size_t work_bytes(int cap, size_t tsize) {
  const size_t n = static_cast<size_t>(cap);
  const size_t p2 = static_cast<size_t>(pow2_at_least(cap));
  return align16(3 * n * tsize) + align16(n * tsize) + 4 * align16(n * 4) +
         2 * align16(p2 * 8) +
         align16((n + 1) * 4) + align16(n * 4);
}

template <typename T>
__device__ inline Work<T> work_at(unsigned char* base, int cap) {
  const size_t n = static_cast<size_t>(cap);
  const size_t p2 = static_cast<size_t>(pow2_at_least(cap));
  Work<T> w;
  w.ask = reinterpret_cast<T*>(base);
  base += align16(3 * n * sizeof(T));
  w.bv = reinterpret_cast<T*>(base);
  base += align16(n * sizeof(T));
  w.row = reinterpret_cast<int*>(base);
  base += align16(n * 4);
  w.bc = reinterpret_cast<int*>(base);
  base += align16(n * 4);
  w.flag = reinterpret_cast<int*>(base);
  base += align16(n * 4);
  w.seg = reinterpret_cast<int*>(base);
  base += align16(n * 4);
  w.khi = reinterpret_cast<unsigned long long*>(base);
  base += align16(p2 * 8);
  w.klo = reinterpret_cast<unsigned long long*>(base);
  base += align16(p2 * 8);
  w.start = reinterpret_cast<int*>(base);
  base += align16((n + 1) * 4);
  w.tau = reinterpret_cast<int*>(base);
  return w;
}

// A bid value's 64-bit key, ascending in value descending: -0.0 reads
// +0.0 first, so equal values get equal keys and tie on the row.
__device__ __forceinline__ unsigned long long desc_key(double v) {
  const double z = v + 0.0;
  const unsigned long long u = static_cast<unsigned long long>(
      __double_as_longlong(z));
  return (u >> 63) ? u : ~(u | 0x8000000000000000ull);
}

// Sorts n keys (khi[q], klo[q]) ascending over the block: a bitonic sort
// of the next power of two, padded with the largest key, unless they are
// in order already.  lo_only sorts khi alone.  Up to blockDim.x keys a thread holds one in registers: the
// exchanges within a warp are shuffles and only those across warps go
// through the arrays, with a barrier; more keys sort in the arrays.
__device__ __forceinline__ bool key_less(unsigned long long ah,
                                         unsigned long long al,
                                         unsigned long long bh,
                                         unsigned long long bl) {
  return ah < bh || (ah == bh && al < bl);
}

__device__ inline void block_sort(unsigned long long* khi,
                                  unsigned long long* klo, int n,
                                  bool lo_only) {
  const int t = threadIdx.x;
  // keys that arrive in order (a contended round: one node, equal bids,
  // rows ascending) are left as they are
  int unsorted = 0;
  for (int q = t + 1; q < n; q += blockDim.x) {
    unsorted |= key_less(khi[q], lo_only ? 0ull : klo[q], khi[q - 1],
                         lo_only ? 0ull : klo[q - 1]) ? 1 : 0;
  }
  if (!__syncthreads_or(unsorted)) return;
  const int p2 = pow2_at_least(n);
  if (p2 <= static_cast<int>(blockDim.x)) {
    unsigned long long h = t < n ? khi[t] : kNoKey;
    unsigned long long l = t < n && !lo_only ? klo[t] : 0ull;
    for (int kk = 2; kk <= p2; kk <<= 1) {
      for (int jj = kk >> 1; jj > 0; jj >>= 1) {
        unsigned long long ph, pl;
        if (jj >= 32) {
          // p2 >= 64: whole warps hold keys, the arrays hold p2 of them
          __syncthreads();  // the arrays' last readers are done
          if (t < p2) {
            khi[t] = h;
            klo[t] = l;
          }
          __syncthreads();
          ph = t < p2 ? khi[t ^ jj] : h;
          pl = t < p2 ? klo[t ^ jj] : l;
        } else {
          ph = __shfl_xor_sync(nk::kFull, h, jj);
          pl = __shfl_xor_sync(nk::kFull, l, jj);
        }
        // the lower index keeps the smaller key going up, the larger
        // going down
        const bool keep_small = ((t & jj) == 0) == ((t & kk) == 0);
        if (keep_small == key_less(ph, pl, h, l) &&
            (ph != h || pl != l)) {
          h = ph;
          l = pl;
        }
      }
    }
    __syncthreads();
    if (t < n) {
      khi[t] = h;
      if (!lo_only) klo[t] = l;
    }
    __syncthreads();
    return;
  }
  for (int q = n + t; q < p2; q += blockDim.x) {
    khi[q] = kNoKey;
    if (!lo_only) klo[q] = kNoKey;
  }
  __syncthreads();
  for (int kk = 2; kk <= p2; kk <<= 1) {
    for (int jj = kk >> 1; jj > 0; jj >>= 1) {
      for (int u = t; u < (p2 >> 1); u += blockDim.x) {
        const int lo = ((u & ~(jj - 1)) << 1) | (u & (jj - 1));
        const int hi = lo + jj;
        const unsigned long long ah = khi[lo];
        const unsigned long long bh = khi[hi];
        const unsigned long long al = lo_only ? 0ull : klo[lo];
        const unsigned long long bl = lo_only ? 0ull : klo[hi];
        if (key_less(bh, bl, ah, al) == ((lo & kk) == 0)) {
          khi[lo] = bh;
          khi[hi] = ah;
          if (!lo_only) {
            klo[lo] = bl;
            klo[hi] = al;
          }
        }
      }
      __syncthreads();
    }
  }
}

// The round scratch in device memory: the two lists of bidding rows
// (this round's, the next's) and their lengths, the items' bests, the
// round-0 walk reads, and block 0's arrays above kSmemRows rows.
struct Scratch {
  void* node;       // T [C, 4]: the rounds' node state (Nodes)
  int32_t* active;  // [2, A]
  int32_t* counts;  // [2]
  void* part_vj;    // T [parts(A, D)] phase B's items' bests
  void* part_v;     // T [parts(A, D)]
  int32_t* part_c;  // [parts(A, D)]
  void* walk_v;     // T [A]
  unsigned char* work;  // Work of A rows, or null
};

// the most phase-B items a round: A * D pairs, or the grid's warps
__host__ __device__ inline size_t parts(int A, int D) {
  return static_cast<size_t>(A) * D + kMaxGrid * (kThreads / 32);
}

// Bytes of the round scratch of an A-row solve over C nodes in D shards.
__host__ __device__ inline size_t scratch_bytes(int A, int C, int D,
                                                size_t tsize) {
  const size_t a = static_cast<size_t>(A);
  const size_t p = parts(A, D);
  return align16(4 * static_cast<size_t>(C) * tsize) + align16(2 * a * 4) +
         align16(2 * 4) + 2 * align16(p * tsize) +
         align16(p * 4) + align16(a * tsize) +
         (A > kSmemRows ? work_bytes(A, tsize) : 0);
}

// Dynamic shared memory of the auction: block 0's arrays up to
// kSmemRows rows.
__host__ __device__ inline size_t smem_bytes(int A, size_t tsize) {
  return A > kSmemRows ? 0 : work_bytes(A, tsize);
}

__device__ inline Scratch carve(void* round, int A, int C, int D,
                                size_t tsize) {
  unsigned char* b = static_cast<unsigned char*>(round);
  const size_t a = static_cast<size_t>(A);
  const size_t p = parts(A, D);
  Scratch x;
  x.node = b;
  b += align16(4 * static_cast<size_t>(C) * tsize);
  x.active = reinterpret_cast<int32_t*>(b);
  b += align16(2 * a * 4);
  x.counts = reinterpret_cast<int32_t*>(b);
  b += align16(2 * 4);
  x.part_vj = b;
  b += align16(p * tsize);
  x.part_v = b;
  b += align16(p * tsize);
  x.part_c = reinterpret_cast<int32_t*>(b);
  b += align16(p * 4);
  x.walk_v = b;
  b += align16(a * tsize);
  x.work = A > kSmemRows ? b : nullptr;
  return x;
}

template <typename T>
__device__ __forceinline__ Nodes<T> nodes_of(const Scratch& x) {
  return {static_cast<T*>(x.node)};
}

// Exclusive prefix sums of f(i) for i < n over the block, a tile of
// blockDim.x at a time: out(i, sum before i, f(i)) for each i; returns
// the total.  Every thread of the block calls it; tmp holds 32 ints.
template <typename F, typename O>
__device__ int block_scan(int n, F f, O out, int* tmp) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int carry = 0;
  for (int base = 0; base < n; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int v = i < n ? f(i) : 0;
    int x = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(nk::kFull, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) tmp[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int t = lane < nw ? tmp[lane] : 0;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(nk::kFull, t, d);
        if (lane >= d) t += y;
      }
      __syncwarp();
      tmp[lane] = t;
    }
    __syncthreads();
    if (i < n) out(i, carry + (warp > 0 ? tmp[warp - 1] : 0) + x - v, v);
    carry += tmp[nw - 1];
    __syncthreads();  // tmp is rewritten by the next tile
  }
  return carry;
}

// The warp's best (value + jitter, value, node) into lane 0's.
template <typename T>
__device__ __forceinline__ void warp_bid(T& vj, T& v, int& c) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const T ovj = __shfl_down_sync(nk::kFull, vj, d);
    const T ov = __shfl_down_sync(nk::kFull, v, d);
    const int oc = __shfl_down_sync(nk::kFull, c, d);
    if (bid_better(ovj, oc, vj, c)) {
      vj = ovj;
      v = ov;
      c = oc;
    }
  }
}

// value of row `row` at global node g (local node l of its shard): score
// - price where the node is feasible and its free capacity fits the ask,
// else -inf.  The mask, free capacity and price are loaded together (the
// last two are shared by the rows a block scans and served by L1: plain
// loads after the grid barrier that published them), the score only
// where ok.
template <typename T>
__device__ __forceinline__ T node_value(const ShardView<T>& v,
                                        const Nodes<T>& nd, size_t rl, int g,
                                        T a0, T a1, T a2) {
  const uint8_t f = __ldg(v.feas + rl);
  T f0, f1, f2, price;
  load_node(nd.v, g, f0, f1, f2, price);
  const bool ok = f != 0 && f0 >= a0 && f1 >= a1 && f2 >= a2;
  return ok ? __ldg(v.scores + rl) - price : T(-INFINITY);
}

// The chunks a shard's nodes split into in phase B: one while the
// (row, shard) pairs fill the grid's warps, more as the rows thin out.
__device__ __forceinline__ int chunks_a_shard(int n_act, int S, int D) {
  const int warps = static_cast<int>(gridDim.x * blockDim.x) >> 5;
  const int pairs = max(1, n_act * D);
  if (pairs >= warps) return 1;
  return max(1, min(min((warps + pairs - 1) / pairs, kMaxSub / D), S / 32));
}

// Phase B over the round's n_act bidding rows: a warp an item.
template <typename T, typename Shards>
__device__ void bid_phase(const Round<T>& r, const Shards& sh,
                          const Scratch& x, const int32_t* act, int n_act,
                          int rnd) {
  const int S = r.S;
  const int D = r.D;
  const int k = chunks_a_shard(n_act, S, D);
  const int per_row = D * k;
  const int items = n_act * per_row;
  const int chunk = (S + k - 1) / k;
  const int lane = threadIdx.x & 31;
  const int gwarp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int nwarps = static_cast<int>(gridDim.x * blockDim.x) >> 5;
  T* part_vj = static_cast<T*>(x.part_vj);
  T* part_v = static_cast<T*>(x.part_v);
  const Nodes<T> nd = nodes_of<T>(x);
  for (int j = gwarp; j < items; j += nwarps) {
    // chunk-major: a block's warps scan one chunk for consecutive rows,
    // so its free capacity and prices come from L1
    const int ch = j / n_act;
    const int i = j - ch * n_act;
    const int s = ch / k;
    const int l0 = (ch - s * k) * chunk;
    const int l1 = min(S, l0 + chunk);
    const int row = act[i];
    const ShardView<T> v = sh.view(s);
    const T a0 = __ldg(r.ask + 3 * row);
    const T a1 = __ldg(r.ask + 3 * row + 1);
    const T a2 = __ldg(r.ask + 3 * row + 2);
    const size_t base = static_cast<size_t>(row) * S;
    T bvj = T(-INFINITY);
    T bv = T(-INFINITY);
    int bc = nk::kInt32Max;
#pragma unroll 4
    for (int l = l0 + lane; l < l1; l += 32) {
      const int g = s * S + l;
      const T value = node_value<T>(v, nd, base + l, g, a0, a1, a2);
      const T vj = value + jitter<T>(row, g);
      if (bid_better(vj, g, bvj, bc)) {
        bvj = vj;
        bv = value;
        bc = g;
      }
    }
    warp_bid<T>(bvj, bv, bc);
    if (lane == 0) {
      part_vj[j] = bvj;
      part_v[j] = bv;
      x.part_c[j] = bc;
      if (rnd == 0 && ch == 0) {
        // round 0 reads the value at the row's walk winner
        const int w = min(max(__ldg(r.rows0 + row), 0), r.C - 1);
        const int so = w / S;
        const int l = w - so * S;
        const ShardView<T> vo = sh.view(so);
        const T wv = node_value<T>(vo, nd, static_cast<size_t>(row) * S + l,
                                   w, a0, a1, a2);
        static_cast<T*>(x.walk_v)[row] = owner_psum(wv, so, D);
      }
    }
  }
}

// Node `key >> 32`'s acceptance bound for its `size` bidders with the
// largest asks mx: m = budget at its free capacity (the round's start),
// which is whole (a floor) or +inf, so rank r is accepted iff r == 0 or
// r < m, that is iff r < tau.
template <typename T>
__device__ __forceinline__ int accept_bound(const Nodes<T>& nd,
                                            unsigned long long key, int size,
                                            T mx0, T mx1, T mx2) {
  const int node = static_cast<int>(key >> 32);
  const T m = budget<T>(nd.f(node, 0), nd.f(node, 1), nd.f(node, 2), mx0,
                        mx1, mx2);
  if (m >= static_cast<T>(size)) return size;
  if (m >= T(1)) return static_cast<int>(m);
  return 1;
}

// Phase RD in block 0: bids, the (node, row) grouping, budget, rank,
// acceptance, debit, prices, the progress flag and the next list.
template <typename T>
__device__ void rank_debit_phase(const Round<T>& r, const Scratch& x,
                                 const Work<T>& w,
                                 const int32_t* act, int32_t* next,
                                 int32_t* next_count, int n_act, int rnd,
                                 int* tmp) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const int S = r.S;
  const int D = r.D;
  const T neg_inf = T(-INFINITY);
  const Nodes<T> nd = nodes_of<T>(x);
  // the items a row had in phase B (the same choice), reduced four at a
  // time so that their loads overlap
  const int per_row = D * chunks_a_shard(n_act, S, D);
  const T* part_vj = static_cast<const T*>(x.part_vj);
  const T* part_v = static_cast<const T*>(x.part_v);
  for (int i = tid; i < n_act; i += blockDim.x) {
    const int row = act[i];
    T bvj = neg_inf;
    T bv = neg_inf;
    int bc = nk::kInt32Max;
    for (int c0 = 0; c0 < per_row; c0 += 4) {
      T cvj[4], cv[4];
      int cc[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = (c0 + u) * n_act + i;
        const bool in = c0 + u < per_row;
        cvj[u] = in ? part_vj[j] : neg_inf;
        cv[u] = in ? part_v[j] : neg_inf;
        cc[u] = in ? x.part_c[j] : nk::kInt32Max;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (bid_better(cvj[u], cc[u], bvj, bc)) {
          bvj = cvj[u];
          bv = cv[u];
          bc = cc[u];
        }
      }
    }
    T bid_v = owner_psum(bv, bc / S, D);
    int bid_c = bc;
    if (rnd == 0) {
      // round 0 bids the serial walk winner when it still fits
      const int r0 = __ldg(r.rows0 + row);
      const T wv = static_cast<const T*>(x.walk_v)[row];
      if (r0 >= 0 && wv > neg_inf) {
        bid_c = min(r0, r.C - 1);
        bid_v = wv;
      }
    }
    w.ask[3 * i] = __ldg(r.ask + 3 * row);
    w.ask[3 * i + 1] = __ldg(r.ask + 3 * row + 1);
    w.ask[3 * i + 2] = __ldg(r.ask + 3 * row + 2);
    w.bv[i] = bid_v;
    w.row[i] = row;
    w.bc[i] = bid_c;
    w.flag[i] = bid_v > neg_inf ? 1 : 0;
  }
  __syncthreads();
  // the bidders in ascending row order, keyed (node, value descending, i)
  const int n = block_scan(
      n_act, [&](int i) { return w.flag[i]; },
      [&](int i, int at, int v) {
        if (v) {
          const unsigned long long vk =
              desc_key(static_cast<double>(w.bv[i]));
          w.khi[at] = (static_cast<unsigned long long>(w.bc[i]) << 32) |
                      (vk >> 32);
          w.klo[at] = (vk << 32) | static_cast<unsigned>(i);
        }
      },
      tmp);
  if (tid == 0) r.progress[rnd] = n > 0 ? 1 : 0;  // rank 0 is accepted
  if (n > 0) {
    block_sort(w.khi, w.klo, n, false);
    // node segments: a position's segment and each segment's start; in a
    // segment the bidders are in rank order
    const int nseg = block_scan(
        n,
        [&](int q) {
          return q == 0 || (w.khi[q] >> 32) != (w.khi[q - 1] >> 32) ? 1 : 0;
        },
        [&](int q, int before, int head) {
          if (head) w.start[before] = q;
          w.seg[q] = before + head - 1;
        },
        tmp);
    if (tid == 0) w.start[nseg] = n;
    __syncthreads();
    // budget: the largest bidder ask per dimension, a thread a segment
    // of up to 32 bidders, a warp a larger one; and the node's price
    for (int s = tid; s < nseg; s += blockDim.x) {
      const int q0 = w.start[s];
      const int q1 = w.start[s + 1];
      if (q1 - q0 > 32) continue;
      T mx0 = T(0), mx1 = T(0), mx2 = T(0);
      for (int q = q0; q < q1; ++q) {
        const T* a = w.ask + 3 * static_cast<int>(w.klo[q] & 0xffffffffu);
        mx0 = fmax(mx0, a[0]);
        mx1 = fmax(mx1, a[1]);
        mx2 = fmax(mx2, a[2]);
      }
      w.tau[s] = accept_bound<T>(nd, w.khi[q0], q1 - q0, mx0, mx1, mx2);
    }
    for (int s = warp; s < nseg; s += nw) {
      const int q0 = w.start[s];
      const int q1 = w.start[s + 1];
      if (q1 - q0 <= 32) continue;  // warp-uniform
      T mx0 = T(0), mx1 = T(0), mx2 = T(0);
      for (int q = q0 + lane; q < q1; q += 32) {
        const T* a = w.ask + 3 * static_cast<int>(w.klo[q] & 0xffffffffu);
        mx0 = fmax(mx0, a[0]);
        mx1 = fmax(mx1, a[1]);
        mx2 = fmax(mx2, a[2]);
      }
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) {
        mx0 = fmax(mx0, __shfl_xor_sync(nk::kFull, mx0, d));
        mx1 = fmax(mx1, __shfl_xor_sync(nk::kFull, mx1, d));
        mx2 = fmax(mx2, __shfl_xor_sync(nk::kFull, mx2, d));
      }
      if (lane == 0) {
        w.tau[s] = accept_bound<T>(nd, w.khi[q0], q1 - q0, mx0, mx1, mx2);
      }
    }
    __syncthreads();
    // acceptance: rank = position in the segment; price += 0.01 on every
    // node with a bidder (its rank-0 position)
    for (int q = tid; q < n; q += blockDim.x) {
      const int s = w.seg[q];
      const int rank = q - w.start[s];
      const int node = static_cast<int>(w.khi[q] >> 32);
      if (rank < w.tau[s]) {
        const int i = static_cast<int>(w.klo[q] & 0xffffffffu);
        const int row = w.row[i];
        r.assigned[row] = node;
        r.acc_round[row] = rnd;
        w.flag[i] = 3;
      }
      if (rank == 0) nd.price(node) = nd.price(node) + static_cast<T>(0.01);
    }
    __syncthreads();
    // the accepted rows in ascending row order, keyed (node, i), grouped
    // by node: the debit adds each node's asks in that order
    const int na = block_scan(
        n_act, [&](int i) { return w.flag[i] == 3 ? 1 : 0; },
        [&](int i, int at, int v) {
          if (v) {
            w.khi[at] = (static_cast<unsigned long long>(w.bc[i]) << 32) |
                        static_cast<unsigned>(i);
          }
        },
        tmp);
    block_sort(w.khi, w.klo, na, true);
    const int nacc = block_scan(
        na,
        [&](int q) {
          return q == 0 || (w.khi[q] >> 32) != (w.khi[q - 1] >> 32) ? 1 : 0;
        },
        [&](int q, int before, int head) {
          if (head) w.start[before] = q;
        },
        tmp);
    if (tid == 0) w.start[nacc] = na;
    __syncthreads();
    for (int s = tid; s < nacc; s += blockDim.x) {
      const int q0 = w.start[s];
      const int q1 = w.start[s + 1];
      T s0 = T(0), s1 = T(0), s2 = T(0);
      for (int q = q0; q < q1; ++q) {
        const T* a = w.ask + 3 * static_cast<int>(w.khi[q] & 0xffffffffu);
        s0 = s0 + a[0];
        s1 = s1 + a[1];
        s2 = s2 + a[2];
      }
      const int node = static_cast<int>(w.khi[q0] >> 32);
      nd.f(node, 0) = nd.f(node, 0) - s0;
      nd.f(node, 1) = nd.f(node, 1) - s1;
      nd.f(node, 2) = nd.f(node, 2) - s2;
    }
  }
  __syncthreads();
  // the next round's bidding rows: the bidders not accepted
  const int nn = block_scan(
      n_act, [&](int i) { return w.flag[i] == 1 ? 1 : 0; },
      [&](int i, int at, int v) {
        if (v) next[at] = w.row[i];
      },
      tmp);
  if (tid == 0) *next_count = nn;
}

// The auction's rounds and epilogue over the solve's shards.  Every
// block of a cooperative launch of kThreads-thread blocks calls it after
// the state is set (the shards' free capacity and prices, assigned = -1,
// the warm start), each block's threads after their own writes of it
// (the node state is copied here by the same grid-stride mapping);
// `smem` holds smem_bytes(A) of dynamic shared memory.
template <typename T, typename Shards>
__device__ void run_auction(const Round<T>& r, const Shards& sh,
                            unsigned char* smem) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int tmp[32];
  const int A = r.A;
  const int tid = threadIdx.x;
  const int gtid = blockIdx.x * blockDim.x + tid;
  const int gsize = gridDim.x * blockDim.x;
  const Scratch x = carve(r.round, A, r.C, r.D, sizeof(T));
  long long* stamps = gtid == 0 ? r.stamps : nullptr;
  if (stamps != nullptr) {
    stamps[0] = kStampsPerRound;
    stamp(stamps + 3);
  }
  // the node state from the shards' free capacity and prices
  const Nodes<T> nd = nodes_of<T>(x);
  for (int g = gtid; g < r.C; g += gsize) {
    const int so = g / r.S;
    const int l = g - so * r.S;
    const ShardView<T> v = sh.view(so);
    nd.f(g, 0) = v.free[3 * l];
    nd.f(g, 1) = v.free[3 * l + 1];
    nd.f(g, 2) = v.free[3 * l + 2];
    nd.price(g) = v.price[l];
  }
  // the first round's bidding rows: the real ones
  if (blockIdx.x == 0) {
    const int n = block_scan(
        A, [&](int a) { return r.real[a] != 0 ? 1 : 0; },
        [&](int a, int at, int v) {
          if (v) x.active[at] = a;
        },
        tmp);
    if (tid == 0) x.counts[0] = n;
  }
  grid.sync();
  if (stamps != nullptr) stamp(stamps + 4);
  int rnd = 0;
  bool progress = true;
  while (rnd < r.max_rounds && progress) {
    const int par = rnd & 1;
    const int32_t* act = x.active + par * A;
    const int n_act = __ldcg(x.counts + par);
    bid_phase<T>(r, sh, x, act, n_act, rnd);
    grid.sync();
    if (stamps != nullptr) stamp(stamps + 5 + kStampsPerRound * rnd);
    if (blockIdx.x == 0) {
      const Work<T> w = A > kSmemRows ? work_at<T>(x.work, A)
                                      : work_at<T>(smem, A);
      rank_debit_phase<T>(r, x, w, act, x.active + (par ^ 1) * A,
                          x.counts + (par ^ 1), n_act, rnd, tmp);
    }
    grid.sync();
    if (stamps != nullptr) stamp(stamps + 6 + kStampsPerRound * rnd);
    progress = __ldcg(r.progress + rnd) != 0;
    ++rnd;
  }
  // the epilogue: pulls (the walk's where the greedy pick held, else the
  // row's candidate count) and the assignment's score through its owner
  const int S = r.S;
  for (int a = gtid; a < A; a += gsize) {
    const int asg = __ldcg(r.assigned + a);
    const bool solved = asg >= 0;
    const bool kept_walk = solved && asg == __ldg(r.rows0 + a);
    r.out_pulls[a] = kept_walk ? __ldg(r.pulls0 + a)
                               : __ldg(r.n_cand + __ldg(r.eval_of + a));
    T score = T(0);
    if (solved) {
      const int g = min(asg, r.C - 1);
      const int so = g / S;
      const int l = g - so * S;
      score = owner_psum(sh.view(so).scores[static_cast<size_t>(a) * S + l],
                         so, r.D);
    }
    r.out_score[a] = score;
  }
  if (gtid == 0) r.out_rounds[0] = rnd;
}

}  // namespace storm
