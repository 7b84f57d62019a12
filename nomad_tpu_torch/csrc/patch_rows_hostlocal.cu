// Kernel K15: the delta-sync store into every node shard this process
// holds of a node-sharded usage mirror, from the process's own
// shard-local staging rows, in place.
//
// Replaces the JAX program nomad_tpu/ops/batch.py:1183
// patch_rows_hostlocal (one `col.at[idx[0]].set(vals[0], mode="drop")`
// per device under shard_map, the [D, w] staging sharded over the node
// axis, so each process ships only its own devices' rows).  Plain twin:
// nomad_tpu_torch/ops/batch.py patch_rows_hostlocal_twin.
//
// Design: one launch for all L local shards (K13 launches once a
// shard).  The grid is (ceil(w / 256), L): block row l reads row l of
// the process's [L, w] staging, whose indices are already local to
// shard l, and stores into shard l through a small by-value array of
// shard pointers.  Padding equals the shard size and is dropped, as is
// any index outside [0, size).  A plain store: the shard is
// bit-identical to the same rows of a fresh upload, and to K13's result
// on the same dirty set.
//
// What bounds it on an H100: L * w indices and values read and the
// owned rows stored, a few kilobytes a flush; launch latency dominates.
//
// Launch: (ceil(w / 256), L) blocks of 256 threads on the caller's
// stream; nothing is synchronised.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kMaxShards = 64;

// Mirrored field for field by the ctypes Structure in ops/_cuda.py.
struct PatchRowsHostlocalArgs {
  void* shards[kMaxShards];  // T [size] each, the local shards
  const void* idx;           // int32 [L, w], shard-local rows
  const void* vals;          // T [L, w]
  int L;
  int size;
  int w;
  int is_f64;
  int device;
};

namespace {

constexpr int kThreads = 256;

template <typename T>
struct ShardPtrs {
  T* p[kMaxShards];
};

template <typename T>
__global__ void patch_rows_hostlocal_kernel(ShardPtrs<T> shards,
                                            const int32_t* __restrict__ idx,
                                            const T* __restrict__ vals,
                                            int size, int w) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= w) return;
  const int l = blockIdx.y;
  const int64_t at = static_cast<int64_t>(l) * w + i;
  const int local = idx[at];
  if (local < 0 || local >= size) return;
  shards.p[l][local] = vals[at];
}

template <typename T>
int launch(const PatchRowsHostlocalArgs* a, cudaStream_t s) {
  ShardPtrs<T> ptrs;
  for (int l = 0; l < kMaxShards; ++l) {
    ptrs.p[l] = l < a->L ? static_cast<T*>(a->shards[l]) : nullptr;
  }
  const dim3 grid((a->w + kThreads - 1) / kThreads, a->L);
  patch_rows_hostlocal_kernel<T><<<grid, kThreads, 0, s>>>(
      ptrs, static_cast<const int32_t*>(a->idx),
      static_cast<const T*>(a->vals), a->size, a->w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int nk_patch_rows_hostlocal(const PatchRowsHostlocalArgs* a,
                                       void* stream) {
  cudaError_t err = cudaSetDevice(a->device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a->L <= 0 || a->w <= 0) return 0;
  if (a->L > kMaxShards) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a->is_f64 ? launch<double>(a, s) : launch<float>(a, s);
}

extern "C" const char* nk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
