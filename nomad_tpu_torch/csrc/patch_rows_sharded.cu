// Kernel K13: the delta-sync scatter into one shard of a node-sharded
// usage mirror, shard[idx - lo] = vals where the row is the shard's,
// in place.
//
// Replaces the JAX program nomad_tpu/ops/batch.py:1130
// patch_rows_sharded (one `col.at[idx - lo].set(vals, mode="drop")`
// per shard under shard_map).  Plain twin: nomad_tpu_torch/ops/batch.py
// patch_rows_sharded_twin.
//
// Design: K4's one thread per staged index (csrc/patch_rows.cu) with
// the shard's first row `lo` and its `size`: the staging is replicated,
// so each shard reads every index and stores only the rows in
// [lo, lo + size); padding (idx == C) lies past every shard and is
// dropped.  One launch per shard.  A plain store: the shard is
// bit-identical to the same rows of a fresh upload.
//
// What bounds it on an H100: W indices read per shard and the owned
// rows stored, a few kilobytes a flush; launch latency dominates.
//
// Launch: ceil(W / 256) blocks of 256 threads on the caller's stream;
// nothing is synchronised.

#include <cuda_runtime.h>
#include <stdint.h>

// Mirrored field for field by the ctypes Structure in ops/_cuda.py.
struct PatchRowsShardedArgs {
  void* col;         // T [size], the shard
  const void* idx;   // int32 [W], global rows
  const void* vals;  // T [W]
  int lo;
  int size;
  int W;
  int is_f64;
  int device;
};

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void patch_rows_sharded_kernel(T* __restrict__ col,
                                          const int32_t* __restrict__ idx,
                                          const T* __restrict__ vals, int lo,
                                          int size, int W) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= W) return;
  const int local = idx[i] - lo;
  if (local < 0 || local >= size) return;
  col[local] = vals[i];
}

}  // namespace

extern "C" int nk_patch_rows_sharded(const PatchRowsShardedArgs* a,
                                     void* stream) {
  cudaError_t err = cudaSetDevice(a->device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a->W <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (a->W + kThreads - 1) / kThreads;
  if (a->is_f64) {
    patch_rows_sharded_kernel<double><<<blocks, kThreads, 0, s>>>(
        static_cast<double*>(a->col), static_cast<const int32_t*>(a->idx),
        static_cast<const double*>(a->vals), a->lo, a->size, a->W);
  } else {
    patch_rows_sharded_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<float*>(a->col), static_cast<const int32_t*>(a->idx),
        static_cast<const float*>(a->vals), a->lo, a->size, a->W);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
