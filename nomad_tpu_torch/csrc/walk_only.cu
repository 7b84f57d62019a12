// Kernel K6: the shuffled limited walk alone, over a score vector that
// the host built — the walk of the CUDA stack's preemption-mode selects.
//
// Replaces the JAX program nomad_tpu/sched/tpu_stack.py:95 _walk_only
// (a jit of nomad_tpu/ops/score.py:186 _limited_walk_argmax).  Plain
// twin: nomad_tpu_torch/ops/score.py limited_walk_argmax.
//
// In preemption mode the host scores every node itself (numpy, with
// the exact per-node eviction evaluation spliced in), so the kernel
// only walks: feasibility and score are read from the given vectors at
// perm[w], and walk.cuh's limited_walk does the rest, exactly as in K1.
//
// What bounds it on an H100: it reads C * (1 + 8 + 4) bytes in f64
// (feasible, scores, perm) and writes 32: at C = 16,384 that is about
// 213 KB, 0.064 us at 3.35 TB/s, with no arithmetic beyond compares and
// counts.  So launch latency and the single block bound it: the walk
// needs walk-order prefix counts and a first-emitted argmax, which one
// block of 1,024 threads gets from block scans and one reduction with no
// cross-block pass.  At this size the launch costs more than the work.
//
// Output: one int64[4] buffer, so the host pays one device->host copy:
// [0] chosen arena row (-1 when no node was emitted), [1] the number of
// feasible positions, [2] pulls, [3] the winner's score as the bits of
// T (a float's bits in the low 32 bits, the high 32 zero).
//
// Launch: one block of 1,024 threads on the caller's stream; nothing is
// allocated here (the wrapper passes C-long scratch) and nothing is
// synchronised.

#include "walk.cuh"

// Mirrored field for field by the ctypes Structure in ops/_cuda.py.
struct WalkOnlyArgs {
  const void* feasible;  // uint8 [C]
  const void* scores;    // T [C]
  const void* perm;      // int32 [C]
  void* s_scratch;       // T [C]
  void* f_scratch;       // uint8 [C]
  void* out;             // int64 [4]
  int limit;
  int n_candidates;
  int C;
  int is_f64;
  int device;
};

namespace {

__device__ __forceinline__ int64_t score_bits(double x) {
  return static_cast<int64_t>(__double_as_longlong(x));
}
__device__ __forceinline__ int64_t score_bits(float x) {
  return static_cast<int64_t>(__float_as_uint(x));
}

template <typename T>
__global__ void __launch_bounds__(nk::kThreads)
    walk_only_kernel(const uint8_t* __restrict__ feasible,
                     const T* __restrict__ scores,
                     const int32_t* __restrict__ perm, T* s_scratch,
                     uint8_t* f_scratch, int64_t* out, int limit,
                     int n_candidates, int C) {
  auto score_at = [&](int w, T& s, bool& f) {
    const int row = perm[w];
    s = scores[row];
    f = feasible[row] != 0;
  };
  const nk::WalkOut<T> r = nk::limited_walk<T>(
      C, limit, n_candidates, s_scratch, f_scratch, score_at);
  if (threadIdx.x == 0) {
    out[0] = r.any ? perm[r.win_w] : nk::kNoNode;
    out[1] = r.feasible_count;
    out[2] = r.pulls;
    out[3] = score_bits(r.best);
  }
}

template <typename T>
void launch(const WalkOnlyArgs& a, cudaStream_t s) {
  walk_only_kernel<T><<<1, nk::kThreads, 0, s>>>(
      static_cast<const uint8_t*>(a.feasible),
      static_cast<const T*>(a.scores), static_cast<const int32_t*>(a.perm),
      static_cast<T*>(a.s_scratch), static_cast<uint8_t*>(a.f_scratch),
      static_cast<int64_t*>(a.out), a.limit, a.n_candidates, a.C);
}

}  // namespace

extern "C" int nk_walk_only(const WalkOnlyArgs* a, void* stream) {
  cudaError_t err = cudaSetDevice(a->device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->is_f64) {
    launch<double>(*a, s);
  } else {
    launch<float>(*a, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
