// Kernel K4: the delta-sync scatter into the batch worker's device usage
// mirror, col[idx] = vals, in place.
//
// Replaces the JAX program nomad_tpu/ops/batch.py:1091 patch_rows
// (`col.at[idx].set(vals, mode="drop")`).  Plain twin:
// nomad_tpu_torch/ops/batch.py patch_rows_twin.
//
// Design: one thread per staged index; an index outside [0, C) is
// dropped (the staging pads its width to a power of two with idx == C).
// The worker stages each dirty row once (sorted, unique), so no two
// threads write one row.  A plain store of the staged value: the
// mirror column is bit-identical to a fresh upload of the host column.
//
// What bounds it on an H100: W scattered 8-byte stores plus 12 bytes
// read per index, a few kilobytes per flush; launch latency dominates.
//
// Launch: ceil(W / 256) blocks of 256 threads on the caller's stream;
// nothing is synchronised.

#include <cuda_runtime.h>
#include <stdint.h>

// Mirrored field for field by the ctypes Structure in ops/_cuda.py.
struct PatchRowsArgs {
  void* col;         // T [C]
  const void* idx;   // int32 [W]
  const void* vals;  // T [W]
  int C;
  int W;
  int is_f64;
  int device;
};

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void patch_rows_kernel(T* __restrict__ col,
                                  const int32_t* __restrict__ idx,
                                  const T* __restrict__ vals, int C, int W) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= W) return;
  const int row = idx[i];
  if (row < 0 || row >= C) return;
  col[row] = vals[i];
}

}  // namespace

extern "C" int nk_patch_rows(const PatchRowsArgs* a, void* stream) {
  cudaError_t err = cudaSetDevice(a->device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a->W <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (a->W + kThreads - 1) / kThreads;
  if (a->is_f64) {
    patch_rows_kernel<double><<<blocks, kThreads, 0, s>>>(
        static_cast<double*>(a->col), static_cast<const int32_t*>(a->idx),
        static_cast<const double*>(a->vals), a->C, a->W);
  } else {
    patch_rows_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<float*>(a->col), static_cast<const int32_t*>(a->idx),
        static_cast<const float*>(a->vals), a->C, a->W);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
