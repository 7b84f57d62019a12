"""Time the PyTorch port's chained planners on the card, kernel K3 (the
batched main path's chain) and kernel K12 (the node-sharded chain on a
VirtualMesh), for one or more checkouts of the repo, so that two commits
are compared on the same card in one run:

    python3 chain_timing.py [TREE ...]

Each TREE (default: the directory of this script) is timed in a process
of its own, in the order given: pass a parent around its change as
``PARENT CHANGE CHANGE PARENT``.  The shapes are chip_smoke.py's timing
phase's, in f64: K3 on one chunk of E = 8 evals x P = 16 picks of the
"plain" chain case over a 16,384-row arena with 10,000 candidates
(`time_chain_kernels`); K12 on one chunk of E = 8 x P = 10 of the
"plain" sharded case at the same width on a VirtualMesh of D = 1 and
D = 8 shards on the one card (`time_sharded_kernels`), the usage carry
reset before each run.  For each tree it prints one JSON line:

- ``k3_ms``: CUDA-event mean of 100 launches after 5 over a prepared
  chain (the tree's `chained_picks_cuda`), ``k3_launches`` its launches
  a chunk, ``k3_blocks`` the grid where the tree reports one;
- ``k12_d1_ms``, ``k12_d8_ms``: CUDA-event mean of 20 chunks after 3
  (the tree's `sharded_chained_plan_cuda` over a prepared chain, with
  its launches and the filling of their argument blocks, which both
  trees do anew for every call, as the path does for every chunk; a
  staged chain's host-side launching shows as the time between its
  kernels), ``k12_d1_launches``, ``k12_d8_launches`` its launches a
  chunk, ``k12_d1_blocks``, ``k12_d8_blocks`` the grid where the tree
  reports one;
- ``k12_d1_host_ms``, ``k12_d8_host_ms``: host-clock mean of 20 such
  calls after 3, each followed by a synchronisation: the chunk's host
  work before its launch is not hidden behind the previous kernel;
- where the tree reports K3's grid: ``barrier_us``, the cost of one
  grid.sync() in microseconds at grids of 1, 8, 33, 66 and K3's grid
  ("full"), from this script's own probe (`BARRIER_PROBE`, built
  beside the tree's kernels): (time of 2,000 barriers - time of 0) /
  2,000, CUDA events, the mean of 5 runs after 2.

The card's name and power limit come first, as nvidia-smi gives them.
Exits 1 without a card, or if any tree's run fails."""
import ctypes
import json
import os
import subprocess
import sys
import time

C, N_CAND = 16_384, 10_000  # chip_smoke.py's C_CHECK, N_CAND_CHECK
K3_SHAPE = (8, 16)  # time_chain_kernels' (E, P)
K12_SHAPE = (8, 10)  # K12_TIMING
BARRIER_GRIDS = (1, 8, 33, 66, 0)  # 0: the grid K3 launches
BARRIERS = 2000

# The grid barrier alone: `iters` grid.sync() calls of 1,024-thread
# blocks and nothing else, launched cooperatively as K3 and K12 are.
BARRIER_PROBE = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>

__global__ void __launch_bounds__(1024, 1) grid_barriers(int iters) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  for (int i = 0; i < iters; ++i) grid.sync();
}

extern "C" int nk_grid_barriers(int iters, int blocks, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* kargs[] = {&iters};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(grid_barriers), dim3(blocks),
      dim3(1024), kargs, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
"""


def _time_ms(fn, n: int, warmup: int) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _k3(cuda) -> dict:
    from nomad_tpu_torch.ops import batch as tbatch
    from nomad_tpu_torch.ops.cases import chain_case
    from nomad_tpu_torch.state.convert import chain_case_to_torch

    E, P = K3_SHAPE
    cols, kw = chain_case(9000, C, N_CAND, "plain", E, P)
    args, kwargs = chain_case_to_torch(cols, kw, cuda)
    prepared = tbatch.prepare_chain(*args, **kwargs)
    rows = tbatch.chained_picks_cuda(prepared)[0]
    twin = tbatch.chained_picks_twin(prepared)[0]
    if not bool((rows == twin).all()):
        raise RuntimeError("K3's rows differ from its twin's")
    before = tbatch.chained_picks_cuda.launches
    out = {"k3_ms": _time_ms(lambda: tbatch.chained_picks_cuda(prepared),
                             100, 5)}
    out["k3_launches"] = (tbatch.chained_picks_cuda.launches - before) / 105
    if hasattr(tbatch.chained_picks_cuda, "blocks"):
        out["k3_blocks"] = tbatch.chained_picks_cuda.blocks
    return out


def _host_ms(fn, n: int, warmup: int) -> float:
    import torch

    for _ in range(warmup):
        fn()
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def _k12(cuda) -> dict:
    from nomad_tpu_torch.ops.cases import (
        SHARDED_CHAIN_SCENARIOS,
        sharded_chain_case,
    )
    from nomad_tpu_torch.parallel.mesh import (
        VirtualMesh,
        prepare_sharded_chain,
        sharded_chain_twin,
        sharded_chained_plan_cuda,
    )
    from nomad_tpu_torch.state.convert import sharded_case_args

    E, P = K12_SHAPE
    si = SHARDED_CHAIN_SCENARIOS.index("plain")
    case = sharded_chain_case(9700 + 10 * si + E, C, N_CAND, "plain", E, P)
    out = {}
    for d in (1, 8):
        mesh = VirtualMesh(d, cuda)
        c = prepare_sharded_chain(mesh, P, sharded_case_args(case, cuda))
        start = [tuple(t.clone() for t in sh.use) for sh in c.shards]

        def reset():
            for sh, cols in zip(c.shards, start):
                for t, t0 in zip(sh.use, cols):
                    t.copy_(t0)

        def kernel():
            reset()
            sharded_chained_plan_cuda(c)

        kernel()
        rows = c.rows.clone()
        reset()
        sharded_chain_twin(c)
        if not bool((rows == c.rows).all()):
            raise RuntimeError(f"K12's rows differ from its twin's at D = {d}")
        before = sharded_chained_plan_cuda.launches
        out[f"k12_d{d}_ms"] = _time_ms(kernel, 20, 3)
        out[f"k12_d{d}_launches"] = (sharded_chained_plan_cuda.launches
                                     - before) / 23
        out[f"k12_d{d}_host_ms"] = _host_ms(kernel, 20, 3)
        if hasattr(sharded_chained_plan_cuda, "blocks"):
            out[f"k12_d{d}_blocks"] = sharded_chained_plan_cuda.blocks
    return out


def _probe():
    """BARRIER_PROBE built by nvcc with the kernels' flags, loaded."""
    from nomad_tpu_torch.ops import _cuda

    out = _cuda.BUILD_DIR / "grid_barriers"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "grid_barriers.cu"
    src.write_text(BARRIER_PROBE)
    lib_path = out / f"libgrid_barriers-{os.getpid()}.so"
    run = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o",
                          str(lib_path), str(src)], capture_output=True,
                         text=True)
    if run.returncode != 0:
        raise RuntimeError(f"the barrier probe did not build:\n{run.stdout}"
                           f"{run.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    lib.nk_grid_barriers.argtypes = [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p]
    lib.nk_grid_barriers.restype = ctypes.c_int
    lib.nk_error_string.argtypes = [ctypes.c_int]
    lib.nk_error_string.restype = ctypes.c_char_p
    return lib


def _barriers(cuda, full: int) -> dict:
    import torch

    lib = _probe()
    stream = ctypes.c_void_p(torch.cuda.current_stream(cuda).cuda_stream)
    out = {}
    for blocks in BARRIER_GRIDS:
        grid = blocks or full

        def run(iters):
            code = lib.nk_grid_barriers(iters, grid, cuda.index, stream)
            if code != 0:
                raise RuntimeError(f"nk_grid_barriers: "
                                   f"{lib.nk_error_string(code).decode()}")

        empty = _time_ms(lambda: run(0), 5, 2)
        many = _time_ms(lambda: run(BARRIERS), 5, 2)
        key = "full" if blocks == 0 else str(blocks)
        out[key] = {"blocks": grid, "us": (many - empty) * 1e3 / BARRIERS}
    return {"barrier_us": out}


def measure(tree: str) -> dict:
    """The timings of `tree`'s K3 and K12, in this process."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch

    from nomad_tpu_torch.ops import _cuda
    from nomad_tpu_torch.ops import batch as tbatch

    if not tbatch.__file__.startswith(tree + os.sep):
        raise RuntimeError(f"imported {tbatch.__file__}, not {tree}'s port")
    cuda = torch.device("cuda", 0)
    _cuda.load(["chained_picks", "sharded_chain"])
    out = {"tree": tree}
    out.update(_k3(cuda))
    out.update(_k12(cuda))
    if "k3_blocks" in out:
        out.update(_barriers(cuda, out["k3_blocks"]))
    return out


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: nothing to time", file=sys.stderr)
        return 1
    if argv[:1] == ["--one"]:
        print(json.dumps(measure(argv[1])), flush=True)
        return 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
          else "nvidia-smi unavailable", flush=True)
    trees = argv or [os.path.dirname(os.path.abspath(__file__))]
    rc = 0
    for tree in map(os.path.abspath, trees):
        run = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", tree], capture_output=True, text=True,
                             cwd=tree)
        lines = run.stdout.strip().splitlines()
        if run.returncode != 0 or not lines:
            print(f"{tree}: exit {run.returncode}\n{run.stderr[-4000:]}",
                  file=sys.stderr)
            rc = 1
            continue
        print(lines[-1], flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
