// Kernel K3's grid chain (chained_picks.cu): the chained planner of
// chained.cuh run by one cooperative grid over the whole card instead
// of one block.  K9 and K10 walk their picks as prefix walks
// (chained_prefix.cuh).
//
// Every eval runs chained.cuh's steps, with the walk of each pick split
// over the grid:
//   * the pre-deltas stay on one thread, in row order; the inverse walk
//     order and the gather of the candidate region into permuted space
//     spread over the grid;
//   * per pick: block 0 opens it (thread 0: the eviction and penalty
//     rows; then the spread slots), barrier; pass A: block b scores its
//     contiguous run of walk positions, flags feasible and bad, and
//     writes its bad total, barrier; each block sums the totals of the
//     blocks before it (there are few), and pass B diverts the first
//     kMaxSkip bad positions in walk order, barrier; pass C: emit
//     order, each block's best (score, emit order, walk position) and
//     its walk position of the limit-th non-diverted node, barrier;
//     block 0 reduces the blocks' bests, thread 0 closes the pick
//     (row, pulls, the winner's deltas, the offset, a dead group) and
//     opens the next active one.  Four grid barriers a pick;
//   * the node-space carry is rebuilt on one thread at the eval's end
//     (chained.cuh rebuild_carry): every successful pick's ask in pick
//     order, then every applied eviction in pick order.
// Pass C's emit order is limited_walk's (walk.cuh), from the grid-wide
// prefix counts: non-diverted positions first, then the diverted ones,
// two of them replayed reversed after a good emission.  The emitted
// positions' (score, emit order) keys are distinct, so the winner is
// the same whatever the reduction's shape; the result does not depend
// on the grid size.
//
// Memory: every array one block writes and another reads (the
// permuted-space columns, the walk flags, the per-block records, the
// offset and the pick index) is read with plain loads after the
// barrier that publishes it, never through __ldg or a __restrict__
// pointer (chained.cuh marks only the kernel's true inputs so).
#pragma once

#include <cooperative_groups.h>

#include "chained.cuh"

namespace nk {

// The grid the per-block records are sized for.
constexpr int kMaxGridBlocks = 1024;

// Per-block records and the chain's grid-wide scalars, in the wrapper's
// scratch (`grid_i_len` int32, `kMaxGridBlocks` T).
template <typename T>
struct GridScratch {
  int32_t* offset;  // [1] the walk offset of the current eval
  int32_t* pick;    // [1] the pick the grid runs next (P: none left)
  int32_t* bad;     // [B] per block: bad positions (pass A)
  int32_t* nd;      // [B] non-diverted feasible positions (pass B)
  int32_t* div;     // [B] diverted positions (pass B)
  int32_t* ord;     // [B] the block's best emit order (pass C)
  int32_t* w;       // [B] its walk position
  int32_t* lth;     // [B] the walk position of the limit-th nd node
  T* s;             // [B] the block's best score
};

constexpr int grid_i_len() { return 2 + 6 * kMaxGridBlocks; }

template <typename T>
__host__ __device__ inline GridScratch<T> bind_grid(int32_t* i, T* f) {
  GridScratch<T> g;
  g.offset = i;
  g.pick = i + 1;
  g.bad = i + 2;
  g.nd = g.bad + kMaxGridBlocks;
  g.div = g.nd + kMaxGridBlocks;
  g.ord = g.div + kMaxGridBlocks;
  g.w = g.ord + kMaxGridBlocks;
  g.lth = g.w + kMaxGridBlocks;
  g.s = f;
  return g;
}

// The sums of N per-block totals over the blocks before `b` and over all
// `nb` blocks, by warp 0; every thread of the block gets them.  Integer
// sums, so the order of the additions does not matter.
template <int N>
__device__ __forceinline__ void blocks_prefix(const int32_t* const (&x)[N],
                                              int b, int nb, int (&before)[N],
                                              int (&total)[N], int* smem) {
  if (threadIdx.x < 32) {
    int pre[N];
    int tot[N];
#pragma unroll
    for (int n = 0; n < N; ++n) pre[n] = tot[n] = 0;
    for (int i = threadIdx.x; i < nb; i += 32) {
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const int v = x[n][i];
        tot[n] += v;
        pre[n] += i < b ? v : 0;
      }
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
#pragma unroll
      for (int n = 0; n < N; ++n) {
        pre[n] += __shfl_down_sync(kFull, pre[n], d);
        tot[n] += __shfl_down_sync(kFull, tot[n], d);
      }
    }
    if (threadIdx.x == 0) {
#pragma unroll
      for (int n = 0; n < N; ++n) {
        smem[n] = pre[n];
        smem[N + n] = tot[n];
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int n = 0; n < N; ++n) {
    before[n] = smem[n];
    total[n] = smem[N + n];
  }
  __syncthreads();  // smem is reused by the next call
}

// Block 0: the inert picks from k0 on get their empty rows, the first
// active one opens (thread 0) and its spread slots are built; the grid
// learns which pick it runs from `g.pick` after the next barrier.
template <typename T>
__device__ void open_next(const Chain<T>& c, const GridScratch<T>& g, int e,
                          int k0, int n_cand, int32_t* rows, int32_t* pulls) {
  __shared__ int next;
  if (threadIdx.x == 0) {
    const int wanted = c.wanted[e];
    int k = k0;
    for (; k < c.P; ++k) {
      if (k < wanted && !c.dead[group_of(c, e, k)]) break;
      rows[k] = kNoNode;
      pulls[k] = 0;
    }
    if (k < c.P) open_pick(c, e, k, group_of(c, e, k), n_cand);
    *g.pick = k;
    next = k;
  }
  __syncthreads();
  const int k = next;
  __syncthreads();  // `next` is rewritten by the next call
  if (k < c.P && c.sp_codes != nullptr) spread_slots(c, e, group_of(c, e, k));
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    chain_grid_kernel(const Chain<T> c, const GridScratch<T> g) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  __shared__ int scan_smem[2 * kWarps + 2];
  __shared__ int tot_smem[4];
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int nb = gridDim.x;
  const int gtid = b * blockDim.x + tid;
  const int gsize = nb * blockDim.x;
  const bool lead = b == 0;  // block 0 runs the serial steps
  const int C = c.C;

  for (int i = gtid; i < C; i += gsize) {
    c.cpu_out[i] = c.cpu_in[i];
    c.mem_out[i] = c.mem_in[i];
    c.disk_out[i] = c.disk_in[i];
  }
  for (int i = gtid; i < c.Q * C; i += gsize) c.ports_out[i] = c.ports_in[i];
  for (int i = gtid; i < c.D * C; i += gsize) c.devs_out[i] = c.devs_in[i];
  grid.sync();

  for (int e = 0; e < c.E; ++e) {
    const int n_cand = c.n_cand[e];
    const int32_t* perm = c.perm + static_cast<size_t>(e) * C;
    int32_t* rows = c.out_rows + static_cast<size_t>(e) * c.P;
    int32_t* pulls = c.out_pulls + static_cast<size_t>(e) * c.P;

    // 1. pre-deltas onto the node-space usage, in order
    if (lead && tid == 0 && c.pre_rows != nullptr) apply_pre(c, e);
    grid.sync();
    // 2. inverse walk order, the candidate region in permuted space
    for (int p = gtid; p < C; p += gsize) c.inv[perm[p]] = p;
    for (int p = gtid; p < n_cand; p += gsize) gather_position(c, e, perm, p);
    if (lead) {
      if (c.sp_codes != nullptr) {
        const size_t base = static_cast<size_t>(e) * c.S * c.V1;
        for (int i = tid; i < c.S * c.V1; i += blockDim.x) {
          c.prop[i] = c.sp_prop0[base + i];
          c.clr[i] = c.sp_clr0[base + i];
        }
      }
      if (tid == 0) {
        *g.offset = 0;
        for (int t = 0; t < c.G; ++t) c.dead[t] = 0;
      }
    }
    grid.sync();
    if (lead) open_next(c, g, e, 0, n_cand, rows, pulls);
    grid.sync();

    // this block's contiguous run of walk positions, and this thread's
    // contiguous part of it
    const int run_b = (n_cand + nb - 1) / nb;
    const int b_lo = min(b * run_b, n_cand);
    const int b_hi = min(b_lo + run_b, n_cand);
    const int run_t = (b_hi - b_lo + kThreads - 1) / kThreads;
    const int lo = min(b_lo + tid * run_t, b_hi);
    const int hi = min(lo + run_t, b_hi);

    // 3. the picks
    for (;;) {
      const int k = *g.pick;  // published by the last barrier
      if (k >= c.P) break;
      const int t = group_of(c, e, k);
      const int limit = c.limit[scalar_at(c, e, k)];
      const int offset = *g.offset;

      // pass A: score, feasibility, bad flags
      int a_cnt[1] = {0};
      for (int w = lo; w < hi; ++w) {
        int p = w + offset;
        if (p >= n_cand) p -= n_cand;
        T s;
        bool f;
        score_position(c, e, k, t, p, s, f);
        uint8_t fl = f ? kFeasible : 0;
        if (f && s <= T(0)) fl |= kBad;
        c.s_w[w] = s;
        c.f_w[w] = fl;
        a_cnt[0] += (fl & kBad) ? 1 : 0;
      }
      int a_tot[1];
      block_exclusive_scan<1>(a_cnt, a_tot, scan_smem);
      if (tid == 0) g.bad[b] = a_tot[0];
      grid.sync();

      // pass B: the first kMaxSkip bad positions are diverted
      int bad_before[1];
      int bad_all[1];
      const int32_t* const bad_tab[1] = {g.bad};
      blocks_prefix<1>(bad_tab, b, nb, bad_before, bad_all, tot_smem);
      int bad_rank = bad_before[0] + a_cnt[0];
      int bc[2] = {0, 0};  // non-diverted feasible, diverted
      for (int w = lo; w < hi; ++w) {
        uint8_t fl = c.f_w[w];
        if (fl & kBad) {
          ++bad_rank;
          if (bad_rank <= kMaxSkip) {
            fl |= kDiverted;
            c.f_w[w] = fl;
          }
        }
        const bool div = (fl & kDiverted) != 0;
        bc[0] += ((fl & kFeasible) && !div) ? 1 : 0;
        bc[1] += div ? 1 : 0;
      }
      int b_tot[2];
      block_exclusive_scan<2>(bc, b_tot, scan_smem);
      if (tid == 0) {
        g.nd[b] = b_tot[0];
        g.div[b] = b_tot[1];
      }
      grid.sync();

      // pass C: emit order, this block's winner, limit-th good node
      int before[2];
      int all[2];
      const int32_t* const nd_tab[2] = {g.nd, g.div};
      blocks_prefix<2>(nd_tab, b, nb, before, all, tot_smem);
      const int nd_count = all[0];
      const int n_div = all[1];
      const bool reverse = (n_div == 2) && (nd_count > 0);
      int nd_incl = before[0] + bc[0];
      int div_incl = before[1] + bc[1];
      Best<T> best;
      best.s = -INFINITY;
      best.ord = kInt32Max;
      best.w = -1;
      best.lth = kInt32Max;
      for (int w = lo; w < hi; ++w) {
        const uint8_t fl = c.f_w[w];
        if (!(fl & kFeasible)) continue;
        int ord;
        if (fl & kDiverted) {
          ++div_incl;
          const int div_rank = div_incl - 1;
          ord = nd_count + (reverse ? 1 - div_rank : div_rank);
        } else {
          ++nd_incl;
          ord = nd_incl - 1;
          if (nd_incl == limit) best.lth = w;
        }
        if (ord < limit) {
          const T s = c.s_w[w];
          if (better(s, ord, best.s, best.ord)) {
            best.s = s;
            best.ord = ord;
            best.w = w;
          }
        }
      }
      best = block_best<T>(best);
      if (tid == 0) {
        g.s[b] = best.s;
        g.ord[b] = best.ord;
        g.w[b] = best.w;
        g.lth[b] = best.lth;
      }
      grid.sync();

      // the blocks' bests reduced; the pick closes, the next one opens
      if (lead) {
        Best<T> v;
        v.s = -INFINITY;
        v.ord = kInt32Max;
        v.w = -1;
        v.lth = kInt32Max;
        for (int i = tid; i < nb; i += blockDim.x) {
          if (better(g.s[i], g.ord[i], v.s, v.ord)) {
            v.s = g.s[i];
            v.ord = g.ord[i];
            v.w = g.w[i];
          }
          v.lth = min(v.lth, g.lth[i]);
        }
        v = block_best<T>(v);
        if (tid == 0) {
          const int any = v.ord != kInt32Max ? 1 : 0;
          const int n_pulls = nd_count >= limit ? v.lth + 1 : n_cand;
          *g.offset = close_pick(c, e, k, t, n_cand, offset, any, v.w,
                                 n_pulls, rows, pulls);
        }
        __syncthreads();
        open_next(c, g, e, k + 1, n_cand, rows, pulls);
      }
      grid.sync();
    }

    // 4. the node-space carry (the next eval's pre-deltas follow on the
    // same thread, then a barrier)
    if (c.chain && lead && tid == 0) rebuild_carry(c, e, rows, pulls);
  }
}

}  // namespace nk
