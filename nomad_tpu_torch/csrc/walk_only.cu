// Kernel K6: the shuffled limited walk alone, over a score vector that
// the host built — the walk of the CUDA stack's preemption-mode selects,
// and of 12a (`sharded_score_and_select`) after its all-gather.
//
// Replaces the JAX program nomad_tpu/sched/tpu_stack.py:95 _walk_only
// (a jit of nomad_tpu/ops/score.py:186 _limited_walk_argmax).  Plain
// twin: nomad_tpu_torch/ops/score.py limited_walk_argmax.
//
// In preemption mode the host scores every node itself (numpy, with the
// exact per-node eviction evaluation spliced in), so the kernel only
// walks: a walk position's feasibility and score are read from the given
// vectors at perm[w] and compared exactly as given (a feasible score of
// -0.0 or 0.0 is bad).  There is no arithmetic beyond the `s <= 0` test.
// K1's two launch shapes, with K1's rule (walk_grid.cuh `takes_grid`):
//
// (a) limit < n_candidates: the prefix walk, one block of picks.cuh's step
// machinery (256 threads, steps of 64 positions doubling to 512) with one
// pick and no rotation over all C walk positions, the tail past
// n_candidates included (it may be feasible); a walk that runs dry pulls
// n_candidates.  It stops after the step holding the limit-th
// non-diverted feasible position (picks.cuh says why that keeps the full
// walk's bits).  With `count` set the block then sweeps the positions it
// did not walk for feasibility alone; the preemption loop, which reads
// only the row and the pulls, leaves it unset and gets -1.
//
// (b) limit >= n_candidates (a group with affinities, spreads or policy
// terms walks unlimited): walk_grid.cuh's cooperative grid of
// 128-thread blocks whose per-block summaries one warp combines; the
// source reads the given vectors in every pass, so no scratch is
// written.  The grid always counts.
//
// What bounds it on an H100: (a) one SM's chain a step (a coalesced perm
// load, then the row's feasibility byte and score, one barrier and a
// warp scan) for the one or two steps a short walk takes: at limit 14 it
// reads ~20 positions' 13 bytes.  (b) the launch and one grid barrier
// (~1.1 us) around C / 128 blocks each reading its positions' perm entry,
// feasibility byte and score (213 KB at C = 16,384 in f64, 0.064 us at
// 3.35 TB/s).
//
// Output: one int64[4] buffer, so the host pays one device->host copy:
// [0] chosen arena row (-1 when no node was emitted), [1] the number of
// feasible positions (-1 where (a) ran without `count`), [2] pulls, [3]
// the winner's score as the bits of T (a float's bits in the low 32 bits,
// the high 32 zero).
//
// Launch: (a) one block on the caller's stream; (b) a cooperative grid
// as large as the card holds, up to C / 128 blocks.  Nothing is allocated
// here (the wrapper passes the summaries, for (b) alone) and nothing is
// synchronised.

#include "picks.cuh"
#include "walk_grid.cuh"

// Mirrored field for field by the ctypes Structure in ops/_cuda.py.
struct WalkOnlyArgs {
  const void* feasible;  // uint8 [C]
  const void* scores;    // T [C]
  const void* perm;      // int32 [C]
  void* summary;         // (b): nk_walk_summary_bytes(C, sizeof(T), limit,
                         // n_candidates); null for (a)
  void* out;             // int64 [4]
  int limit;
  int n_candidates;
  int C;
  int is_f64;
  int device;
  int count;  // (a): count the feasible positions it did not walk
};

namespace {

template <typename T>
struct Walk {
  const uint8_t* __restrict__ feasible;
  const T* __restrict__ scores;
  const int32_t* __restrict__ perm;
  nk::GridSums<T> sums;
  int64_t* out;
  int limit, n_candidates, C;
  bool count;
};

__device__ __forceinline__ int64_t score_bits(double x) {
  return static_cast<int64_t>(__double_as_longlong(x));
}
__device__ __forceinline__ int64_t score_bits(float x) {
  return static_cast<int64_t>(__float_as_uint(x));
}

// Both shapes' source: walk position w's row is perm[w]; its feasibility
// and score are the given vectors' there.
template <typename T>
struct GivenSource {
  const Walk<T>& c;

  // (a): a step's positions, the perm entries first (coalesced), then the
  // rows' feasibility bytes, then the feasible rows' scores
  template <int W>
  __device__ __forceinline__ void step(const int (&p)[W],
                                       const bool (&valid)[W], int, bool,
                                       T (&s)[W], bool (&f)[W]) {
    int row[W];
#pragma unroll
    for (int r = 0; r < W; ++r) row[r] = valid[r] ? __ldg(c.perm + p[r]) : 0;
#pragma unroll
    for (int r = 0; r < W; ++r) {
      f[r] = valid[r] && __ldg(c.feasible + row[r]) != 0;
    }
#pragma unroll
    for (int r = 0; r < W; ++r) s[r] = f[r] ? __ldg(c.scores + row[r]) : T(0);
  }
  // nothing to remember after the count ballots
  __device__ __forceinline__ void note(int, int, bool, bool) {}

  // (b): the given vectors in every pass
  __device__ __forceinline__ bool score(int w, T& s) const {
    const int row = __ldg(c.perm + w);
    const bool f = __ldg(c.feasible + row) != 0;
    if (f) s = __ldg(c.scores + row);
    return f;
  }
  __device__ __forceinline__ uint8_t flags(int w, bool) const {
    T s = T(0);
    const bool f = score(w, s);
    return f ? static_cast<uint8_t>(nk::kFeasible |
                                    (s <= T(0) ? nk::kBad : 0))
             : 0;
  }
  __device__ __forceinline__ T score_at(int w, bool) const {
    return __ldg(c.scores + __ldg(c.perm + w));
  }
};

__device__ __forceinline__ void write_out(int64_t* out, int64_t row,
                                          int64_t feasible, int64_t pulls,
                                          int64_t bits) {
  out[0] = row;
  out[1] = feasible;
  out[2] = pulls;
  out[3] = bits;
}

template <typename T>
__global__ void __launch_bounds__(nk::kPickThreads)
    walk_only_prefix_kernel(const Walk<T> c) {
  __shared__ nk::PickShared<T> sh;
  GivenSource<T> src{c};
  const nk::WalkEnd<T> r =
      nk::prefix_walk<T>(src, sh, c.C, 0, c.limit, c.n_candidates);
  int feasible = r.feasible;
  if (c.count) {
    // the positions the walk did not reach: feasibility alone
    int mine = 0;
    for (int w = r.walked + threadIdx.x; w < c.C; w += nk::kPickThreads) {
      mine += __ldg(c.feasible + __ldg(c.perm + w)) != 0;
    }
    feasible += nk::block_sum(mine);
  }
  if (threadIdx.x == 0) {
    write_out(c.out, r.win_w >= 0 ? c.perm[r.win_w] : nk::kNoNode,
              c.count ? feasible : -1, r.pulls, score_bits(r.best));
  }
}

template <typename T>
__global__ void __launch_bounds__(nk::kGridThreads)
    walk_only_grid_kernel(const Walk<T> c) {
  const GivenSource<T> src{c};
  nk::GridEnd<T> r;
  if (nk::grid_walk<T>(src, c.sums, c.C, c.limit, c.n_candidates, r)) {
    write_out(c.out, r.win_w >= 0 ? c.perm[r.win_w] : nk::kNoNode,
              r.feasible, r.pulls, score_bits(r.best));
  }
}

template <typename T>
cudaError_t launch(const WalkOnlyArgs& a, cudaStream_t s) {
  Walk<T> c;
  c.feasible = static_cast<const uint8_t*>(a.feasible);
  c.scores = static_cast<const T*>(a.scores);
  c.perm = static_cast<const int32_t*>(a.perm);
  c.sums = nk::bind_sums<T>(a.summary, a.C);
  c.out = static_cast<int64_t*>(a.out);
  c.limit = a.limit;
  c.n_candidates = a.n_candidates;
  c.C = a.C;
  c.count = a.count != 0;
  if (!nk::takes_grid(a.limit, a.n_candidates)) {
    walk_only_prefix_kernel<T><<<1, nk::kPickThreads, 0, s>>>(c);
    return cudaGetLastError();
  }
  if (a.summary == nullptr) return cudaErrorInvalidValue;
  static int capacity[64] = {0};
  return nk::launch_grid(walk_only_grid_kernel<T>, c, a.C, a.device,
                         capacity, s);
}

}  // namespace

extern "C" int nk_walk_only(const WalkOnlyArgs* a, void* stream) {
  if (a->C < 1 || a->limit < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(a->device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = a->is_f64 ? launch<double>(*a, s) : launch<float>(*a, s);
  return static_cast<int>(err);
}

// Bytes of (b)'s per-block summaries for a C-position walk with this
// limit and candidate count: 0 where the rule takes (a), which reads none.
extern "C" size_t nk_walk_summary_bytes(int C, int t_size, int limit,
                                        int n_candidates) {
  return nk::takes_grid(limit, n_candidates)
             ? nk::summary_bytes(C, static_cast<size_t>(t_size))
             : 0;
}

extern "C" const char* nk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
