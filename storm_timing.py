"""Time the PyTorch port's storm auction on the card, kernel K5 (the
global storm solve) and kernel K14 (the node-sharded storm solve on a
VirtualMesh), for one or more checkouts of the repo, so that two commits
are compared on the same card in one run:

    python3 storm_timing.py [TREE ...]

Each TREE (default: the directory of this script) is timed in a process
of its own, in the order given: pass a parent around its change as
``PARENT CHANGE CHANGE PARENT``.  All in f64, on two problems:

- ``path``: the storm path's own problem, the first solve of
  chip_smoke.py's storm phase (1,024 dispatch children over the
  10,000-node world's 16,384-row arena, A = E = 1,024).  It is built once
  by this script's directory, in a process of its own under
  PYTHONHASHSEED=STORM_HASH_SEED (chip_smoke.py's `run_storm` on the
  card with the solve's inputs kept), and saved under
  ``build/storm_timing/``; every tree loads that file;
- ``dogpile``: chip_smoke.py's timing case (`storm_case(9900, 1,024,
  1,024, 16,384, "dogpile")`).

For each tree and problem it prints, in one JSON line a tree:

- ``k5_ms``: CUDA-event mean of N solves after a warm-up (the tree's
  `storm_assignment_cuda`), ``k5_host_ms`` the host-clock mean of
  synchronised solves, ``k5_launches`` the wrapper's count a solve, and
  ``rounds``;
- ``k14_d1_*``, ``k14_d8_*``: the same for K14 (the tree's
  `storm_assignment_sharded_cuda` over a prepared solve on a
  VirtualMesh of D shards on the one card), with ``launches`` its
  kernel launches a solve;
- ``*_stamps``, where the tree's wrappers take a stamp buffer: the
  kernels' %globaltimer stamps read as microseconds: the score and walk
  passes, the auction's set-up, and per phase of a round (B, R, D in a
  three-barrier round; B and RD in a two-barrier one) summed over the
  rounds, in all and by how many rows were still unassigned when the
  round began.  A stamp is taken by one thread after the grid barrier
  that ends a phase, so a phase's time includes its barrier;
- ``k14_d*_stages``, where K14 is staged on a VirtualMesh: CUDA-event
  milliseconds of one solve's stage launches summed by kind, of the
  mesh's exchanges, and what is left of the solve's time (the host's
  launching and its read of the progress flag a round);
- ``barrier_us``: one grid barrier, from this script's own probe
  (`BARRIER_PROBE`), at the grids of the two auction designs: 1,024
  blocks of 256 threads and 132 of 1,024.

The card's name and power limit come first, as nvidia-smi gives them.
Exits 1 without a card, or if any tree's run fails."""
import ctypes
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

HERE = os.path.dirname(os.path.abspath(__file__))
PROBLEM = os.path.join(HERE, "build", "storm_timing", "problem.pt")
STORM_HASH_SEED = "17"
DOGPILE = (9900, 1024, 1024, 16_384)  # chip_smoke.py's time_storm_kernel
REPEATS = {"path": (5, 1, 3), "dogpile": (20, 2, 5)}  # events, warm-up, host
K14_REPEATS = {"path": (3, 1, 2), "dogpile": (10, 2, 3)}
STAGE_KINDS = ("score", "walk", "bid", "cand", "read", "bids", "budget",
               "accept", "debit", "epi_read", "finish")
EXCHANGES = ("gather", "pmax", "pmin", "psum")
# rows still unassigned when a round began: the buckets of the split
BUCKETS = ((512, 1 << 30), (64, 511), (8, 63), (1, 7), (0, 0))
BARRIERS = 2000
BARRIER_GRIDS = ((1024, 256), (132, 1024))

# The grid barrier alone: `iters` grid.sync() calls and nothing else,
# launched cooperatively as the auctions are.
BARRIER_PROBE = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>

__global__ void grid_barriers(int iters) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  for (int i = 0; i < iters; ++i) grid.sync();
}

extern "C" int nk_grid_barriers(int iters, int blocks, int threads,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* kargs[] = {&iters};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(grid_barriers), dim3(blocks),
      dim3(threads), kargs, 0, static_cast<cudaStream_t>(stream));
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


def _host_ms(fn, n: int) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


# -- the storm path's problem -------------------------------------------------


def build_problem(out: str) -> dict:
    """chip_smoke.py's storm phase on the card with the first solve's
    inputs kept (as its check_storm keeps them), saved to `out`."""
    import torch

    sys.path.insert(0, HERE)
    import chip_smoke
    from nomad_tpu_torch.server.batch_worker import BatchWorker

    cuda = torch.device("cuda", 0)
    solved = []
    orig = BatchWorker._storm_solve

    def keep_problem(self, problem, snap):
        out = orig(self, problem, snap)
        if not solved:
            # no commit ran since the solve: the mirror is what K5 read
            cols = tuple(c.detach().cpu().clone()
                         for c in self._device_columns(snap.node_table))
            solved.append((problem, cols))
        return out

    BatchWorker._storm_solve = keep_problem
    try:
        run = chip_smoke.run_storm(cuda, True, "storm_timing problem")
    finally:
        BatchWorker._storm_solve = orig
    if not run["ok"] or not solved:
        raise RuntimeError("the storm run kept no problem")
    problem, cols = solved[0]
    inputs = {k: (None if v is None else torch.from_numpy(
        __import__("numpy").ascontiguousarray(v)))
        for k, v in problem.inputs._asdict().items()}
    os.makedirs(os.path.dirname(out), exist_ok=True)
    torch.save({"inputs": inputs, "cols": list(cols),
                "spread_fit": bool(problem.spread_fit),
                "max_rounds": int(problem.max_rounds)}, out)
    return {"A": int(inputs["ask"].shape[0]), "C": int(cols[0].shape[0]),
            "placed": run["placed"]}


def _load_problems(cuda) -> dict:
    import torch

    from nomad_tpu_torch.ops.cases import storm_case
    from nomad_tpu_torch.ops.solve import StormInputs
    from nomad_tpu_torch.state.convert import storm_columns, storm_inputs

    blob = torch.load(PROBLEM)
    inp = StormInputs(**{k: None if v is None else v.to(cuda)
                         for k, v in blob["inputs"].items()})
    cols = tuple(c.to(cuda) for c in blob["cols"])
    seed, E, A, C = DOGPILE
    dcols, dinp, drounds = storm_case(seed, E, A, C, "dogpile")
    return {
        "path": (inp, cols, blob["spread_fit"], blob["max_rounds"]),
        "dogpile": (storm_inputs(dinp, cuda), storm_columns(dcols, cuda),
                    False, drounds),
    }


# -- the stamps ---------------------------------------------------------------


def _unassigned(inp, out) -> list:
    acc = out.accept_round.cpu()
    real = int(inp.real.sum())
    return [real - int(((acc >= 0) & (acc < r)).sum())
            for r in range(int(out.rounds))]


def stamp_split(stamps, inp, out) -> dict:
    """The stamp buffer's microseconds: score and walk passes, the
    auction's set-up, and each phase of a round summed over the rounds,
    in all and by the rows unassigned when the round began."""
    s = [int(x) for x in stamps.cpu().tolist()]
    per = s[0]
    names = ["B", "R", "D"] if per == 3 else ["B", "RD"]
    us = lambda a, b: (b - a) / 1e3  # noqa: E731
    split = {"score": us(s[1], s[2]), "walk": us(s[2], s[3]),
             "setup": us(s[3], s[4]), "stamps_a_round": per}
    unass = _unassigned(inp, out)
    total = dict.fromkeys(names, 0.0)
    buckets = {f"{lo}-{hi}" if hi < 1 << 30 else f">={lo}":
               dict(rounds=0, **dict.fromkeys(names, 0.0))
               for lo, hi in BUCKETS}
    prev = s[4]
    for r, u in enumerate(unass):
        for k, name in enumerate(names):
            t = s[5 + per * r + k]
            total[name] += us(prev, t)
            for (lo, hi), b in zip(BUCKETS, buckets.values()):
                if lo <= u <= hi:
                    b[name] += us(prev, t)
            prev = t
        for (lo, hi), b in zip(BUCKETS, buckets.values()):
            if lo <= u <= hi:
                b["rounds"] += 1
    split["rounds"] = total
    split["by_unassigned"] = {k: v for k, v in buckets.items() if v["rounds"]}
    split["auction"] = us(s[4], prev)
    return split


def _takes_stamps(fn) -> bool:
    import inspect

    return "stamps" in inspect.signature(fn).parameters


# -- K14's staged stages, by kind ----------------------------------------------


def staged_split(tsolve, _cuda, st) -> dict:
    """One staged K14 solve with CUDA events around every stage launch
    and every exchange of the mesh: milliseconds by kind, and the rest of
    the solve's event time."""
    import torch

    ev = defaultdict(list)
    base = _cuda.StormShardedStages

    def timed(kind, fn):
        def run(*args):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args)
            b.record()
            ev[kind].append((a, b))
            return out
        return run

    class Timed(base):
        pass

    for kind in STAGE_KINDS:
        setattr(Timed, kind, (lambda k: lambda self, *a: timed(
            k, lambda *x: getattr(base, k)(self, *x))(*a))(kind))
    mesh = st.mesh
    depth = [0]
    for kind in EXCHANGES:
        orig = getattr(mesh, kind)

        def outer(*a, _o=orig, _k=kind, **kw):
            # psum gathers: time the outermost exchange only
            depth[0] += 1
            try:
                if depth[0] > 1:
                    return _o(*a, **kw)
                return timed("x_" + _k, lambda: _o(*a, **kw))()
            finally:
                depth[0] -= 1
        setattr(mesh, kind, outer)
    _cuda.StormShardedStages = Timed
    try:
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        tsolve.storm_assignment_sharded_cuda(st)
        b.record()
        torch.cuda.synchronize()
    finally:
        _cuda.StormShardedStages = base
        for kind in EXCHANGES:
            delattr(mesh, kind)
    out = {k: sum(x.elapsed_time(y) for x, y in v) for k, v in ev.items()}
    out["launches_by_kind"] = {k: len(v) for k, v in ev.items()}
    total = a.elapsed_time(b)
    out["solve_ms"] = total
    out["rest_ms"] = total - sum(v for k, v in out.items()
                                 if isinstance(v, float) and k != "solve_ms")
    return out


# -- the barrier probe ----------------------------------------------------------


def _barriers(cuda) -> dict:
    import torch

    from nomad_tpu_torch.ops import _cuda

    out_dir = _cuda.BUILD_DIR / "storm_barriers"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "storm_barriers.cu"
    src.write_text(BARRIER_PROBE)
    lib_path = out_dir / f"libstorm_barriers-{os.getpid()}.so"
    run = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o",
                          str(lib_path), str(src)], capture_output=True,
                         text=True)
    if run.returncode != 0:
        raise RuntimeError(f"the barrier probe did not build:\n{run.stdout}"
                           f"{run.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    lib.nk_grid_barriers.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.nk_grid_barriers.restype = ctypes.c_int
    lib.nk_error_string.argtypes = [ctypes.c_int]
    lib.nk_error_string.restype = ctypes.c_char_p
    stream = ctypes.c_void_p(torch.cuda.current_stream(cuda).cuda_stream)
    out = {}
    for blocks, threads in BARRIER_GRIDS:
        def go(iters):
            code = lib.nk_grid_barriers(iters, blocks, threads, cuda.index,
                                        stream)
            if code != 0:
                raise RuntimeError(lib.nk_error_string(code).decode())
        empty = _time_ms(lambda: go(0), 5, 2)
        many = _time_ms(lambda: go(BARRIERS), 5, 2)
        out[f"{blocks}x{threads}"] = (many - empty) * 1e3 / BARRIERS
    return out


# -- one tree ---------------------------------------------------------------------


def measure(tree: str) -> dict:
    """The timings of `tree`'s K5 and K14, in this process."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch

    from nomad_tpu_torch.ops import _cuda
    from nomad_tpu_torch.ops import solve as tsolve
    from nomad_tpu_torch.parallel.mesh import VirtualMesh

    if not tsolve.__file__.startswith(tree + os.sep):
        raise RuntimeError(f"imported {tsolve.__file__}, not {tree}'s port")
    cuda = torch.device("cuda", 0)
    _cuda.load(["storm_solve", "storm_sharded"])
    out = {"tree": tree}
    k5_stamps = _takes_stamps(tsolve.storm_assignment_cuda)
    k14_stamps = _takes_stamps(tsolve.storm_assignment_sharded_cuda)
    for name, (inp, cols, spread_fit, max_rounds) in _load_problems(
            cuda).items():
        n, warm, n_host = REPEATS[name]
        args = (inp, cols, spread_fit, max_rounds)
        k5 = tsolve.storm_assignment_cuda(*args)
        torch.cuda.synchronize()
        before = tsolve.storm_assignment_cuda.launches
        row = {"A": int(inp.ask.shape[0]), "E": int(inp.feasible.shape[0]),
               "C": int(cols[0].shape[0]), "rounds": int(k5.rounds)}
        row["k5_ms"] = _time_ms(lambda: tsolve.storm_assignment_cuda(*args),
                                n, warm)
        row["k5_host_ms"] = _host_ms(
            lambda: tsolve.storm_assignment_cuda(*args), n_host)
        row["k5_launches"] = ((tsolve.storm_assignment_cuda.launches - before)
                              / (n + warm + n_host))
        if k5_stamps:
            stamps = torch.zeros(_cuda.storm_stamp_len(max_rounds),
                                 dtype=torch.int64, device=cuda)
            res = tsolve.storm_assignment_cuda(*args, stamps=stamps)
            torch.cuda.synchronize()
            row["k5_stamps"] = stamp_split(stamps, inp, res)
        n, warm, n_host = K14_REPEATS[name]
        for d in (1, 8):
            st = tsolve.prepare_sharded_storm(VirtualMesh(d, cuda), inp, cols,
                                              spread_fit, max_rounds)
            res = tsolve.storm_assignment_sharded_cuda(st)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(res, k5))
            if not same:
                raise RuntimeError(f"K14 at D = {d} differs from K5 on {name}")
            before = tsolve.storm_assignment_sharded_cuda.launches
            key = f"k14_d{d}"
            row[key + "_ms"] = _time_ms(
                lambda: tsolve.storm_assignment_sharded_cuda(st), n, warm)
            row[key + "_host_ms"] = _host_ms(
                lambda: tsolve.storm_assignment_sharded_cuda(st), n_host)
            row[key + "_launches"] = (
                (tsolve.storm_assignment_sharded_cuda.launches - before)
                / (n + warm + n_host))
            if hasattr(_cuda, "StormShardedStages") and not hasattr(
                    _cuda, "StormShardedCoop"):
                row[key + "_stages"] = staged_split(tsolve, _cuda, st)
            if k14_stamps:
                stamps = torch.zeros(_cuda.storm_stamp_len(max_rounds),
                                     dtype=torch.int64, device=cuda)
                res = tsolve.storm_assignment_sharded_cuda(st, stamps=stamps)
                torch.cuda.synchronize()
                row[key + "_stamps"] = stamp_split(stamps, inp, res)
        out[name] = row
    out["barrier_us"] = _barriers(cuda)
    return out


def _problem() -> None:
    """Build the path's problem once, in a process of its own."""
    if os.path.exists(PROBLEM):
        return
    env = dict(os.environ, PYTHONHASHSEED=STORM_HASH_SEED)
    run = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--problem", PROBLEM], capture_output=True,
                         text=True, cwd=HERE, env=env)
    if run.returncode != 0:
        raise RuntimeError(f"the storm path's problem was not built: exit "
                           f"{run.returncode}\n{run.stderr[-4000:]}")
    print(run.stdout.strip().splitlines()[-1], flush=True)


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: nothing to time", file=sys.stderr)
        return 1
    if argv[:1] == ["--one"]:
        print(json.dumps(measure(argv[1])), flush=True)
        return 0
    if argv[:1] == ["--problem"]:
        print(json.dumps({"problem": build_problem(argv[1])}), flush=True)
        return 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
          else "nvidia-smi unavailable", flush=True)
    _problem()
    trees = argv or [HERE]
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
