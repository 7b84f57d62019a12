// Kernel K2: the look-ahead scan — P sequential picks of one task group
// in one launch — behind the CUDA stack's count > 1 selects.
//
// Replaces the JAX program nomad_tpu/ops/batch.py:766 plan_picks_full
// (via the single-group _run_picks :347, _walk :281, _rotated_prefix
// :268).  Plain twin: nomad_tpu_torch/ops/batch.py run_picks.
//
// Design: one block of 1,024 threads loops over the picks.  A prologue
// gathers the candidate region of every column through `perm` into
// permuted-space scratch, so each pick reads contiguous memory: walk
// position w is permuted index (w + offset) mod n_cand, a rotation with
// one wrap (the JAX program's closed-form _rotated_prefix, taken as an
// index map).  Tail positions (>= n_cand) are never feasible and never
// rotate, so they are not walked.  Each pick scores the region, runs
// the shared limited walk (walk.cuh), then thread 0 scatters the
// winner's usage and collision deltas and advances the offset; a
// barrier publishes them to the next pick.  After the first failed
// pick the rest are inert (rows -1, pulls 0), as in the JAX scan.
//
// What bounds it on an H100: per pick it reads about n_cand * (7 * 8 +
// 6) bytes from L2 (~1 MB at 16k candidates in f64) and does two
// double pows per node; with P picks in sequence and three barriered
// passes per pick it is bound by the latency of one SM's serial chain,
// not by bandwidth.  The single block gives up the other SMs; the
// chained E x P variant of the next slice adds an outer loop over evals
// around the same pick body (pick_loop below).
//
// Launch: one block on the caller's stream; scratch comes from the
// wrapper; nothing is synchronised.

#include "walk.cuh"

// Mirrored field for field by the ctypes Structure in ops/_cuda.py.
struct PlanPicksArgs {
  const void* cpu_total;
  const void* mem_total;
  const void* disk_total;
  const void* cpu_used;    // base usage, node space
  const void* mem_used;
  const void* disk_used;
  const void* feasible;    // uint8 [C]
  const void* collisions;  // int32 [C]
  const void* penalty;     // uint8 [C]
  const void* affinity;
  const void* perm;        // int32 [C]
  void* f_scratch;         // T [8, n_cand]
  void* i_scratch;         // int32 [n_cand]
  void* b_scratch;         // uint8 [2, n_cand]
  void* out;               // int32 [2, n_picks]: rows; pulls
  double ask_cpu;
  double ask_mem;
  double ask_disk;
  int desired;
  int limit;
  int n_cand;
  int C;
  int n_picks;
  int distinct_hosts;
  int spread_fit;
  int is_f64;
  int device;
};

namespace {

// permuted-space static bits
constexpr uint8_t kStaticFeasible = 1;
constexpr uint8_t kPenalty = 2;

template <typename T>
struct Picks {
  // node-space inputs
  const T* __restrict__ cpu_total;
  const T* __restrict__ mem_total;
  const T* __restrict__ disk_total;
  const T* __restrict__ cpu_used;
  const T* __restrict__ mem_used;
  const T* __restrict__ disk_used;
  const uint8_t* __restrict__ feasible;
  const int32_t* __restrict__ collisions;
  const uint8_t* __restrict__ penalty;
  const T* __restrict__ affinity;
  const int32_t* __restrict__ perm;
  // permuted-space columns and carries
  T* cpu_total_p;
  T* mem_total_p;
  T* disk_total_p;
  T* cpu_p;
  T* mem_p;
  T* disk_p;
  T* aff_p;
  T* s_w;
  int32_t* coll_p;
  uint8_t* bits_p;
  uint8_t* f_w;
  int32_t* out;
  T ask_cpu, ask_mem, ask_disk, desired;
  int limit, n_cand, n_picks;
  bool distinct_hosts, spread_fit;
};

// The pick loop over the permuted-space carries: writes rows[k] and
// pulls[k] for k in [0, n_picks).
template <typename T>
__device__ void pick_loop(const Picks<T>& c, int* sh_offset, int* sh_dead) {
  const int n_cand = c.n_cand;
  for (int k = 0; k < c.n_picks; ++k) {
    const int offset = *sh_offset;
    auto score_at = [&](int w, T& s, bool& f) {
      int p = w + offset;
      if (p >= n_cand) p -= n_cand;
      const T cpu_after = c.cpu_p[p] + c.ask_cpu;
      const T mem_after = c.mem_p[p] + c.ask_mem;
      const T disk_after = c.disk_p[p] + c.ask_disk;
      const T cpu_total = c.cpu_total_p[p];
      const T mem_total = c.mem_total_p[p];
      const bool fit = (cpu_after <= cpu_total) & (mem_after <= mem_total) &
                       (disk_after <= c.disk_total_p[p]);
      const int coll = c.coll_p[p];
      const uint8_t bits = c.bits_p[p];
      f = ((bits & kStaticFeasible) != 0) & fit &
          !(c.distinct_hosts & (coll > 0));
      s = nk::score_node<T, false>(cpu_total, mem_total, cpu_after,
                                   mem_after, coll, (bits & kPenalty) != 0,
                                   c.aff_p[p], T(0), c.desired,
                                   c.spread_fit);
    };
    const nk::WalkOut<T> r = nk::limited_walk<T>(n_cand, c.limit, n_cand,
                                                 c.s_w, c.f_w, score_at);
    if (threadIdx.x == 0) {
      if (r.any) {
        int p = r.win_w + offset;
        if (p >= n_cand) p -= n_cand;
        c.out[k] = c.perm[p];
        c.cpu_p[p] = c.cpu_p[p] + c.ask_cpu;
        c.mem_p[p] = c.mem_p[p] + c.ask_mem;
        c.disk_p[p] = c.disk_p[p] + c.ask_disk;
        c.coll_p[p] = c.coll_p[p] + 1;
      } else {
        c.out[k] = nk::kNoNode;
        *sh_dead = 1;
      }
      c.out[c.n_picks + k] = r.pulls;
      *sh_offset = (offset + r.pulls) % n_cand;
    }
    __syncthreads();
    if (*sh_dead) {
      // the scheduler coalesces the group's later placements after its
      // first failure: the remaining picks are inert
      for (int j = k + 1 + threadIdx.x; j < c.n_picks; j += blockDim.x) {
        c.out[j] = nk::kNoNode;
        c.out[c.n_picks + j] = 0;
      }
      return;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(nk::kThreads)
    plan_picks_kernel(const Picks<T> c) {
  __shared__ int sh_offset;
  __shared__ int sh_dead;
  for (int p = threadIdx.x; p < c.n_cand; p += blockDim.x) {
    const int row = c.perm[p];
    c.cpu_total_p[p] = c.cpu_total[row];
    c.mem_total_p[p] = c.mem_total[row];
    c.disk_total_p[p] = c.disk_total[row];
    c.cpu_p[p] = c.cpu_used[row];
    c.mem_p[p] = c.mem_used[row];
    c.disk_p[p] = c.disk_used[row];
    c.aff_p[p] = c.affinity[row];
    c.coll_p[p] = c.collisions[row];
    c.bits_p[p] = (c.feasible[row] ? kStaticFeasible : 0) |
                  (c.penalty[row] ? kPenalty : 0);
  }
  if (threadIdx.x == 0) {
    sh_offset = 0;
    sh_dead = 0;
  }
  __syncthreads();
  pick_loop<T>(c, &sh_offset, &sh_dead);
}

template <typename T>
Picks<T> typed(const PlanPicksArgs& a) {
  Picks<T> c;
  c.cpu_total = static_cast<const T*>(a.cpu_total);
  c.mem_total = static_cast<const T*>(a.mem_total);
  c.disk_total = static_cast<const T*>(a.disk_total);
  c.cpu_used = static_cast<const T*>(a.cpu_used);
  c.mem_used = static_cast<const T*>(a.mem_used);
  c.disk_used = static_cast<const T*>(a.disk_used);
  c.feasible = static_cast<const uint8_t*>(a.feasible);
  c.collisions = static_cast<const int32_t*>(a.collisions);
  c.penalty = static_cast<const uint8_t*>(a.penalty);
  c.affinity = static_cast<const T*>(a.affinity);
  c.perm = static_cast<const int32_t*>(a.perm);
  T* f = static_cast<T*>(a.f_scratch);
  const size_t n = static_cast<size_t>(a.n_cand);
  c.cpu_total_p = f;
  c.mem_total_p = f + n;
  c.disk_total_p = f + 2 * n;
  c.cpu_p = f + 3 * n;
  c.mem_p = f + 4 * n;
  c.disk_p = f + 5 * n;
  c.aff_p = f + 6 * n;
  c.s_w = f + 7 * n;
  c.coll_p = static_cast<int32_t*>(a.i_scratch);
  uint8_t* b = static_cast<uint8_t*>(a.b_scratch);
  c.bits_p = b;
  c.f_w = b + n;
  c.out = static_cast<int32_t*>(a.out);
  // host doubles round to T here exactly as the twin's torch.as_tensor
  c.ask_cpu = static_cast<T>(a.ask_cpu);
  c.ask_mem = static_cast<T>(a.ask_mem);
  c.ask_disk = static_cast<T>(a.ask_disk);
  c.desired = static_cast<T>(a.desired);
  c.limit = a.limit;
  c.n_cand = a.n_cand;
  c.n_picks = a.n_picks;
  c.distinct_hosts = a.distinct_hosts != 0;
  c.spread_fit = a.spread_fit != 0;
  return c;
}

}  // namespace

extern "C" int nk_plan_picks(const PlanPicksArgs* a, void* stream) {
  cudaError_t err = cudaSetDevice(a->device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->is_f64) {
    plan_picks_kernel<double><<<1, nk::kThreads, 0, s>>>(typed<double>(*a));
  } else {
    plan_picks_kernel<float><<<1, nk::kThreads, 0, s>>>(typed<float>(*a));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
