// Kernel K11: every node's (feasible, final score) of one select, with
// no walk.
//
// Replaces the JAX program nomad_tpu/ops/score.py:282 score_all, which
// is _score_vectors (:110, with its policy branch :163-180 and _pow10
// :69) alone.  Plain twin: nomad_tpu_torch/ops/score.py score_all_twin.
//
// Design: an elementwise pass, one thread per node row, over walk.cuh's
// score_node — the per-node arithmetic K1 runs inside its walk — with
// the `kPolicy` branch when a policy group is present (a null column
// marks an absent group).  The feasibility written is the static mask
// AND the fit of the ask, as `_score_vectors` returns it.  The policy
// terms are added unconditionally and only their counts predicated, so
// a -0.0 term is an exact no-op, as in the JAX program.
//
// What bounds it on an H100: it reads every column once (six f64
// columns, two byte masks, one int32 column, affinity and spread, and
// the policy columns when present) and writes a byte and a score a node:
// ~1.5 MB at C = 16,384 in f64, about 0.45 us at 3.35 TB/s.  Each node
// takes two double pows, so at that size it is bound by launch latency.
//
// Launch: ceil(C / 256) blocks of 256 threads on the caller's stream;
// nothing is allocated here and nothing is synchronised.

#include "walk.cuh"

// Mirrored field for field by the ctypes Structure in ops/_cuda.py.
struct ScoreAllArgs {
  const void* cpu_total;
  const void* mem_total;
  const void* disk_total;
  const void* cpu_used;
  const void* mem_used;
  const void* disk_used;
  const void* feasible;    // uint8 [C]
  const void* collisions;  // int32 [C]
  const void* penalty;     // uint8 [C]
  const void* affinity;
  const void* spread;
  const void* tput_term;   // T [C] or null (no throughput group)
  const void* mig_term;    // T [C] or null (no migration group)
  void* out_feasible;      // uint8 [C]
  void* out_final;         // T [C]
  double ask_cpu;
  double ask_mem;
  double ask_disk;
  double has_tput;         // the throughput term's count
  int desired;
  int C;
  int spread_fit;
  int is_f64;
  int device;
};

namespace {

constexpr int kBlock = 256;

template <typename T>
struct Cols {
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
  const T* __restrict__ spread;
  const T* __restrict__ tput_term;
  const T* __restrict__ mig_term;
  uint8_t* out_feasible;
  T* out_final;
  T ask_cpu, ask_mem, ask_disk, desired, has_tput;
  int C;
  bool spread_fit;
};

template <typename T, bool kPolicy>
__global__ void __launch_bounds__(kBlock) score_all_kernel(const Cols<T> c) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= c.C) return;
  const T cpu_after = c.cpu_used[row] + c.ask_cpu;
  const T mem_after = c.mem_used[row] + c.ask_mem;
  const T disk_after = c.disk_used[row] + c.ask_disk;
  const T cpu_total = c.cpu_total[row];
  const T mem_total = c.mem_total[row];
  const bool fit = (cpu_after <= cpu_total) & (mem_after <= mem_total) &
                   (disk_after <= c.disk_total[row]);
  nk::PolicyNode<T> pol;
  if (kPolicy) {
    pol.tput_on = c.tput_term != nullptr;
    pol.tput = pol.tput_on ? c.tput_term[row] : T(0);
    pol.has_tput = c.has_tput;
    pol.mig_on = c.mig_term != nullptr;
    pol.mig = pol.mig_on ? c.mig_term[row] : T(0);
  }
  c.out_feasible[row] = (c.feasible[row] != 0) & fit;
  c.out_final[row] = nk::score_node<T, true, false, kPolicy>(
      cpu_total, mem_total, cpu_after, mem_after, c.collisions[row],
      c.penalty[row] != 0, c.affinity[row], c.spread[row], c.desired,
      c.spread_fit, T(0), false, pol);
}

template <typename T>
Cols<T> typed(const ScoreAllArgs& a) {
  Cols<T> c;
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
  c.spread = static_cast<const T*>(a.spread);
  c.tput_term = static_cast<const T*>(a.tput_term);
  c.mig_term = static_cast<const T*>(a.mig_term);
  c.out_feasible = static_cast<uint8_t*>(a.out_feasible);
  c.out_final = static_cast<T*>(a.out_final);
  // host doubles round to T here exactly as the twin's torch.as_tensor
  c.ask_cpu = static_cast<T>(a.ask_cpu);
  c.ask_mem = static_cast<T>(a.ask_mem);
  c.ask_disk = static_cast<T>(a.ask_disk);
  c.desired = static_cast<T>(a.desired);
  c.has_tput = static_cast<T>(a.has_tput);
  c.C = a.C;
  c.spread_fit = a.spread_fit != 0;
  return c;
}

template <typename T>
void launch(const ScoreAllArgs& a, cudaStream_t s) {
  const int blocks = (a.C + kBlock - 1) / kBlock;
  if (a.tput_term != nullptr || a.mig_term != nullptr) {
    score_all_kernel<T, true><<<blocks, kBlock, 0, s>>>(typed<T>(a));
  } else {
    score_all_kernel<T, false><<<blocks, kBlock, 0, s>>>(typed<T>(a));
  }
}

}  // namespace

extern "C" int nk_score_all(const ScoreAllArgs* a, void* stream) {
  cudaError_t err = cudaSetDevice(a->device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a->C < 1) return static_cast<int>(cudaErrorInvalidValue);
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
