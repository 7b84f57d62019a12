// Kernels K4, K13 and K15: the delta-sync store into a usage mirror of
// K columns, in place, from one staging of dirty rows.  The mirror is
// node-sharded (K13, K15: every node shard this process holds) or
// plain (K4: one [C] column a usage field, the one-shard case of K13):
//
//   K4 (hostlocal = 0, L = 1, first = 0, size = C): the batch worker's
//     unsharded mirror and the per-column `patch_rows`, col[idx] = vals
//     with idx outside [0, C) dropped.  Replaces the JAX program
//     nomad_tpu/ops/batch.py:1091 patch_rows (`col.at[idx].set(vals,
//     mode="drop")`, one program a column).  Plain twin:
//     nomad_tpu_torch/ops/batch.py patch_rows_twin.
//   K13 (hostlocal = 0): a replicated staging of global rows, idx [W];
//     shard[idx - lo] = vals where the row is the shard's.  Replaces the
//     JAX program nomad_tpu/ops/batch.py:1130 patch_rows_sharded (one
//     `col.at[idx - lo].set(vals, mode="drop")` per shard under
//     shard_map, one program a column).  Plain twin:
//     nomad_tpu_torch/ops/batch.py patch_rows_sharded_cols_twin (K = 1:
//     patch_rows_sharded_twin).
//   K15 (hostlocal = 1): the process's own [L, w] staging of shard-local
//     rows, row l for local shard l, padding the shard size.  Replaces
//     nomad_tpu/ops/batch.py:1183 patch_rows_hostlocal (one
//     `col.at[idx[0]].set(vals[0], mode="drop")` per device under
//     shard_map, the [D, w] staging sharded over the node axis).  Plain
//     twin: patch_rows_hostlocal_cols_twin (K = 1:
//     patch_rows_hostlocal_twin).
//
// Design: one launch for all L local shards and all K columns (the
// mirror's flush stores cpu, mem and disk at once: K = 3).  One thread
// per staged row reads its index once.  K13 derives the owning shard as
// idx / size - first, where `first` is the process's first shard, and
// drops the row unless 0 <= idx and the shard is local, so padding
// (idx == C) and other processes' rows never store; a flush reads W
// indices, not L * W.  For K4 (one shard of C rows) the padding index
// C divides to shard 1 and is dropped, and a negative row is dropped
// before the division, exactly as `mode="drop"` drops both.  K15's
// thread t stores into shard t / w and drops an index outside
// [0, size).  The thread then stores its row into the
// K columns through a by-value table of [K][L] shard pointers (no table
// upload, no per-shard launch).  A plain store: the shard is
// bit-identical to the same rows of a fresh upload, and K13 and K15
// give the same mirror on the same dirty set.
//
// What bounds it on an H100: the indices and K values a staged row read
// and the owned rows stored, a few kilobytes a flush, microseconds
// below the launch latency; the host's path to the launch is what the
// flush pays, so the wrapper binds the table once per mirror (sharded
// or plain) and a flush only writes the staging pointers and W.
//
// Launch: ceil(n / 256) blocks of 256 threads on the caller's stream,
// n = W (K4, K13) or L * W (K15); nothing is synchronised.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kMaxCols = 4;
constexpr int kMaxShards = 64;

// column k, local shard l at k * kMaxShards + l; passed by value
struct Table {
  void* p[kMaxCols * kMaxShards];
};

// Mirrored field for field by the ctypes Structure in ops/_cuda.py.
struct PatchRowsMeshArgs {
  Table cols;
  const void* idx;   // int32 [W] global rows, or [L, W] shard-local
  const void* vals;  // T [K, *idx]
  int K;
  int L;
  int first;      // the process's first shard (K13)
  int size;       // rows a shard
  int W;          // staged rows, or the staging row's width (K15)
  int hostlocal;  // 0: K13, 1: K15
  int is_f64;
  int device;
};

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void patch_rows_mesh_kernel(Table tab,
                                       const int32_t* __restrict__ idx,
                                       const T* __restrict__ vals, int K,
                                       int L, int first, int size, int W,
                                       int hostlocal) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t n = hostlocal ? static_cast<int64_t>(L) * W : W;
  if (t >= n) return;
  const int row = idx[t];
  int shard, local;
  if (hostlocal) {
    if (row < 0 || row >= size) return;  // padding
    shard = static_cast<int>(t / W);
    local = row;
  } else {
    if (row < 0) return;
    shard = row / size - first;
    if (shard < 0 || shard >= L) return;  // padding, or another process's
    local = row - (first + shard) * size;
  }
  for (int k = 0; k < K; ++k) {
    static_cast<T*>(tab.p[k * kMaxShards + shard])[local] =
        vals[static_cast<int64_t>(k) * n + t];
  }
}

}  // namespace

extern "C" int nk_patch_rows_mesh(const PatchRowsMeshArgs* a, void* stream) {
  if (a->K < 1 || a->K > kMaxCols || a->L < 1 || a->L > kMaxShards ||
      a->size < 1 || a->first < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != a->device) err = cudaSetDevice(a->device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a->W <= 0) return 0;
  const int64_t n = a->hostlocal ? static_cast<int64_t>(a->L) * a->W : a->W;
  const int blocks = static_cast<int>((n + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* idx = static_cast<const int32_t*>(a->idx);
  if (a->is_f64) {
    patch_rows_mesh_kernel<double><<<blocks, kThreads, 0, s>>>(
        a->cols, idx, static_cast<const double*>(a->vals), a->K, a->L,
        a->first, a->size, a->W, a->hostlocal);
  } else {
    patch_rows_mesh_kernel<float><<<blocks, kThreads, 0, s>>>(
        a->cols, idx, static_cast<const float*>(a->vals), a->K, a->L,
        a->first, a->size, a->W, a->hostlocal);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
