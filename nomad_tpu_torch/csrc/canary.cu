// Kernel K8: the device supervisor's canary, out[i] = a[i] + 1 and the
// sum of out, in one launch.
//
// Replaces the JAX program nomad_tpu/device/supervisor.py:494, the
// freshly traced `jax.jit(lambda a: a + 1)(x).sum()` on an 8-vector of
// ones (16.0 comes back).  Plain twin: nomad_tpu_torch/ops/canary.py
// canary_plain.
//
// Design: one block of T threads, T the power of two at or above n,
// capped at 1024.  Thread t adds one to elements t, t + T, t + 2T, ...
// in ascending order, storing each and summing them from 0; the T
// partial sums are then halved in shared memory, s[t] += s[t + h] for
// h = T/2, T/4, ..., 1.  The order is fixed, so the sum is the same bits
// on every launch, and the twin repeats it exactly.  Built with
// -fmad=false like every kernel here (there is nothing to contract).
//
// What bounds it on an H100: nothing the card notices — 8 values in, 8
// and a sum out (136 bytes), 15 additions.  A launch costs its launch
// latency; what the supervisor measures with it is whether the card
// answers at all.  So the supervisor's probe is bound once
// (ops/canary.py CanaryProbe): its inputs, outputs and sum live in one
// block of mapped pinned host memory (nk_mapped_alloc), the argument
// block points at that block's device address, and a probe is this one
// launch, whose loads of the inputs cross the bus from host memory and
// whose stores of out and the sum cross back: no allocation, no copy.
//
// Launch: one block on the caller's stream; nothing is synchronised.

#include <cuda_runtime.h>

// Mirrored field for field by the ctypes Structure in ops/_cuda.py.
struct CanaryArgs {
  const void* a;  // T [n]
  void* out;      // T [n]
  void* sum;      // T [1]
  int n;
  int threads;    // T: a power of two, 1..1024
  int is_f64;
  int device;
};

namespace {

constexpr int kMaxThreads = 1024;

template <typename T>
__global__ void canary_kernel(const T* __restrict__ a, T* __restrict__ out,
                              T* __restrict__ sum, int n) {
  __shared__ T partial[kMaxThreads];
  const int t = threadIdx.x;
  const int threads = blockDim.x;
  T acc = T(0);
  for (int i = t; i < n; i += threads) {
    const T v = a[i] + T(1);
    out[i] = v;
    acc = acc + v;
  }
  partial[t] = acc;
  __syncthreads();
  for (int h = threads / 2; h > 0; h /= 2) {
    if (t < h) partial[t] = partial[t] + partial[t + h];
    __syncthreads();
  }
  if (t == 0) *sum = partial[0];
}

}  // namespace

extern "C" int nk_canary(const CanaryArgs* a, void* stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != a->device) err = cudaSetDevice(a->device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a->threads < 1 || a->threads > kMaxThreads ||
      (a->threads & (a->threads - 1)) != 0 || a->n < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->is_f64) {
    canary_kernel<double><<<1, a->threads, 0, s>>>(
        static_cast<const double*>(a->a), static_cast<double*>(a->out),
        static_cast<double*>(a->sum), a->n);
  } else {
    canary_kernel<float><<<1, a->threads, 0, s>>>(
        static_cast<const float*>(a->a), static_cast<float*>(a->out),
        static_cast<float*>(a->sum), a->n);
  }
  return static_cast<int>(cudaGetLastError());
}

// A block of `bytes` of pinned host memory mapped into the address space
// of `device`: *host is its host address, *dev the address a kernel
// reads and writes it at.  Freed by nk_mapped_free.
extern "C" int nk_mapped_alloc(size_t bytes, int device, void** host,
                               void** dev) {
  *host = nullptr;
  *dev = nullptr;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* h = nullptr;
  err = cudaHostAlloc(&h, bytes, cudaHostAllocMapped | cudaHostAllocPortable);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* d = nullptr;
  err = cudaHostGetDevicePointer(&d, h, 0);
  if (err != cudaSuccess) {
    cudaFreeHost(h);
    return static_cast<int>(err);
  }
  *host = h;
  *dev = d;
  return 0;
}

extern "C" int nk_mapped_free(void* host) {
  return static_cast<int>(cudaFreeHost(host));
}

extern "C" const char* nk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
