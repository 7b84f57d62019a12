"""Build and bind the hand-written CUDA kernels of `csrc/`.

Each kernel source is compiled by `nvcc` for `sm_90a` into its own
shared library with a plain C interface and loaded with ctypes: a
source that does not include PyTorch's headers builds in seconds, so a
fresh machine pays the build once per process start, inside the run.
Libraries go to ``build/torch_kernels/`` beside the package, named by a
hash of their sources and flags, and are reused while that hash holds.
All sources are compiled at once, one `nvcc` each, in parallel.

Nothing here runs at import: the build happens on the first launch (or
an explicit `build_all`).  There is no fallback: a missing `nvcc`, a
failed build or a refused launch raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Tuple

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"

SOURCES = {
    "score_select": "score_select.cu",
    "plan_picks": "plan_picks.cu",
    "chained_picks": "chained_picks.cu",
    "patch_rows": "patch_rows.cu",
    "storm_solve": "storm_solve.cu",
    "walk_only": "walk_only.cu",
    "batch_picks": "batch_picks.cu",
    "canary": "canary.cu",
    "chained_batch": "chained_batch.cu",
    "batch_plan": "batch_plan.cu",
    "score_all": "score_all.cu",
    "sharded_chain": "sharded_chain.cu",
    "patch_rows_sharded": "patch_rows_sharded.cu",
    "storm_sharded": "storm_sharded.cu",
    "patch_rows_hostlocal": "patch_rows_hostlocal.cu",
}
HEADERS = ("walk.cuh", "picks.cuh", "chained.cuh")

# exact IEEE arithmetic: no FMA contraction, no fast math, no
# flush-to-zero, correctly rounded division
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-fmad=false",
    "-ftz=false",
    "-prec-div=true",
    "-prec-sqrt=true",
    "-Xptxas=-v",
    "-shared",
    "-Xcompiler=-fPIC",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, Dict] = {}
# one build or load at a time in this process: a batch worker's thread
# and a warm-up on another thread may both reach their first launch
_LOCK = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = []
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    for exe in candidates:
        if os.path.exists(exe):
            return exe
    raise RuntimeError(
        "nvcc not found (CUDA_HOME unset and no nvcc on PATH): the CUDA "
        "kernels cannot be built"
    )


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for fname in (SOURCES[name],) + HEADERS:
        h.update((CSRC / fname).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=None) -> Dict[str, Dict]:
    """Compile every kernel library that is missing, one nvcc per
    source, all started together.  Returns {name: {"path", "seconds",
    "cached", "ptxas"}} and raises on any failed build."""
    names = list(names or SOURCES)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    pending = {}
    for name in names:
        path = _lib_path(name)
        if path.exists():
            BUILD_LOG.setdefault(
                name, {"path": str(path), "seconds": 0.0, "cached": True,
                       "ptxas": ""}
            )
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / SOURCES[name])]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        pending[name] = (proc, tmp, path, time.perf_counter())
    errors = []
    for name, (proc, tmp, path, t0) in pending.items():
        out, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"{name}: nvcc exit {proc.returncode}\n{out}")
            continue
        os.replace(tmp, path)
        BUILD_LOG[name] = {"path": str(path), "seconds": seconds,
                           "cached": False, "ptxas": out}
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return {n: BUILD_LOG[n] for n in names}


def library(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        with _LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                build_all([name])
                lib = ctypes.CDLL(BUILD_LOG[name]["path"])
                lib.nk_error_string.argtypes = [ctypes.c_int]
                lib.nk_error_string.restype = ctypes.c_char_p
                _LIBS[name] = lib
    return lib


def load(names) -> None:
    """Build every library of `names` that this process has not loaded
    (one nvcc each, all started together) and load them: what a caller
    runs before a deadline-bound stage reaches its first launch."""
    with _LOCK:
        missing = [n for n in names if n not in _LIBS]
        if missing:
            build_all(missing)
    for name in missing:
        library(name)


_P = ctypes.c_void_p
_D = ctypes.c_double
_I = ctypes.c_int


class ScoreSelectArgs(ctypes.Structure):
    """Mirror of `ScoreSelectArgs` in csrc/score_select.cu."""

    _fields_ = [
        ("cpu_total", _P), ("mem_total", _P), ("disk_total", _P),
        ("cpu_used", _P), ("mem_used", _P), ("disk_used", _P),
        ("feasible", _P), ("collisions", _P), ("penalty", _P),
        ("affinity", _P), ("spread", _P), ("perm", _P),
        ("tput_term", _P), ("mig_term", _P),
        ("s_scratch", _P), ("f_scratch", _P), ("out_i", _P),
        ("out_best", _P),
        ("ask_cpu", _D), ("ask_mem", _D), ("ask_disk", _D),
        ("has_tput", _D),
        ("desired", _I), ("limit", _I), ("n_candidates", _I), ("C", _I),
        ("spread_fit", _I), ("is_f64", _I), ("device", _I),
    ]


class PlanPicksArgs(ctypes.Structure):
    """Mirror of `PlanPicksArgs` in csrc/plan_picks.cu."""

    _fields_ = [
        ("cpu_total", _P), ("mem_total", _P), ("disk_total", _P),
        ("cpu_used", _P), ("mem_used", _P), ("disk_used", _P),
        ("feasible", _P), ("collisions", _P), ("penalty", _P),
        ("affinity", _P), ("perm", _P),
        ("f_scratch", _P), ("i_scratch", _P), ("b_scratch", _P),
        ("out", _P),
        ("ask_cpu", _D), ("ask_mem", _D), ("ask_disk", _D),
        ("desired", _I), ("limit", _I), ("n_cand", _I), ("C", _I),
        ("n_picks", _I), ("distinct_hosts", _I), ("spread_fit", _I),
        ("is_f64", _I), ("device", _I),
    ]


def _launch(name: str, fn_name: str, args: ctypes.Structure,
            device: torch.device) -> None:
    lib = library(name)
    fn = getattr(lib, fn_name)
    fn.argtypes = [ctypes.POINTER(type(args)), _P]
    fn.restype = _I
    stream = torch.cuda.current_stream(device).cuda_stream
    code = fn(ctypes.byref(args), _P(stream))
    if code != 0:
        msg = lib.nk_error_string(code).decode()
        raise RuntimeError(f"{fn_name} launch failed: {msg} ({code})")


def launch_score_select(cols, s_scratch, f_scratch, out_i, out_best, *,
                        tput_term, has_tput: float, mig_term,
                        ask: Tuple[float, float, float], desired: int,
                        limit: int, n_candidates: int,
                        spread_fit: bool) -> None:
    """K1 on the current stream.  `cols` maps ScoreInputs column names
    to contiguous CUDA tensors (the wrapper has checked them);
    `tput_term` and `mig_term` are the policy groups' contiguous
    columns, or None for an absent group."""
    dev = cols["cpu_total"].device
    args = ScoreSelectArgs(
        cols["cpu_total"].data_ptr(), cols["mem_total"].data_ptr(),
        cols["disk_total"].data_ptr(), cols["cpu_used"].data_ptr(),
        cols["mem_used"].data_ptr(), cols["disk_used"].data_ptr(),
        cols["feasible"].data_ptr(), cols["collisions"].data_ptr(),
        cols["penalty"].data_ptr(), cols["affinity_score"].data_ptr(),
        cols["spread_boost"].data_ptr(), cols["perm"].data_ptr(),
        _ptr(tput_term), _ptr(mig_term),
        s_scratch.data_ptr(), f_scratch.data_ptr(), out_i.data_ptr(),
        out_best.data_ptr(),
        ask[0], ask[1], ask[2], has_tput,
        desired, limit, n_candidates, cols["cpu_total"].shape[0],
        int(spread_fit), int(cols["cpu_total"].dtype == torch.float64),
        dev.index,
    )
    _launch("score_select", "nk_score_select", args, dev)


def launch_plan_picks(cols, f_scratch, i_scratch, b_scratch, out, *,
                      ask: Tuple[float, float, float], desired: int,
                      limit: int, n_candidates: int, n_picks: int,
                      distinct_hosts: bool, spread_fit: bool) -> None:
    """K2 on the current stream.  `cols` maps column names (totals and
    BatchInputs fields) to contiguous CUDA tensors."""
    dev = cols["cpu_total"].device
    args = PlanPicksArgs(
        cols["cpu_total"].data_ptr(), cols["mem_total"].data_ptr(),
        cols["disk_total"].data_ptr(), cols["base_cpu_used"].data_ptr(),
        cols["base_mem_used"].data_ptr(),
        cols["base_disk_used"].data_ptr(), cols["feasible"].data_ptr(),
        cols["base_collisions"].data_ptr(), cols["penalty"].data_ptr(),
        cols["affinity_score"].data_ptr(), cols["perm"].data_ptr(),
        f_scratch.data_ptr(), i_scratch.data_ptr(), b_scratch.data_ptr(),
        out.data_ptr(),
        ask[0], ask[1], ask[2],
        desired, limit, n_candidates, cols["cpu_total"].shape[0],
        n_picks, int(distinct_hosts), int(spread_fit),
        int(cols["cpu_total"].dtype == torch.float64), dev.index,
    )
    _launch("plan_picks", "nk_plan_picks", args, dev)



class ChainedPicksArgs(ctypes.Structure):
    """Mirror of `ChainedPicksArgs` in csrc/chained_picks.cu."""

    _fields_ = [
        (name, _P) for name in (
            "cpu_total", "mem_total", "disk_total", "cpu_in", "mem_in",
            "disk_in", "cpu_out", "mem_out", "disk_out", "feasible",
            "perm", "ask_cpu", "ask_mem", "ask_disk", "desired", "limit",
            "distinct_hosts", "tg_idx", "n_cand", "wanted", "coll0",
            "affinity", "sp_codes", "sp_desired", "sp_used0", "sp_prop0",
            "sp_clr0", "sp_weight", "sp_active", "sp_even", "sp_group",
            "evict_rows", "evict_cpu", "evict_mem", "evict_disk",
            "evict_coll", "penalty_rows", "pre_rows", "pre_cpu", "pre_mem",
            "pre_disk", "port_ask", "ports_in", "ports_out", "dev_ask",
            "devs_in", "devs_out", "dev_aff", "dev_aff_on", "occ0",
            "dh_tg", "f_scratch", "i_scratch", "b_scratch", "s_scratch",
            "out_rows", "out_pulls",
        )
    ] + [
        (name, _I) for name in (
            "E", "P", "G", "C", "S", "V1", "K", "R", "Q", "D",
            "spread_fit", "is_f64", "device",
        )
    ]


class PatchRowsArgs(ctypes.Structure):
    """Mirror of `PatchRowsArgs` in csrc/patch_rows.cu."""

    _fields_ = [
        ("col", _P), ("idx", _P), ("vals", _P),
        ("C", _I), ("W", _I), ("is_f64", _I), ("device", _I),
    ]


def _ptr(t) -> int:
    """Device address of an optional tensor (0 for an absent one)."""
    return 0 if t is None else t.data_ptr()


def _chain_dims(p) -> Dict[str, int]:
    sp, dl, pre = p["spread"], p["deltas"], p["pre"]
    return dict(
        E=p["E"], P=p["P"], G=p["T"], C=p["C"],
        S=0 if sp is None else sp.codes.shape[1],
        V1=0 if sp is None else sp.desired.shape[2],
        K=0 if dl is None else dl.penalty_rows.shape[2],
        R=0 if pre is None else pre.rows.shape[1],
        Q=0 if p["port_ask"] is None else p["port_ask"].shape[2],
        D=0 if p["dev_ask"] is None else p["dev_ask"].shape[2],
    )


def _scratch_lens(C, G=1, S=0, V1=0, Q=0, D=0) -> Tuple[int, ...]:
    """Lengths of one eval's scratch in `csrc/chained.cuh` (its
    `*_scratch_len`): float, int32, byte and spread-carry elements."""
    return ((7 + 2 * G) * C, (2 + G + S + D) * C + G, (2 + G + Q) * C,
            3 * S * V1 + 4 * S + 1)


def chained_scratch(p, dtype, device) -> Tuple[torch.Tensor, ...]:
    """K3's scratch: permuted-space float columns (totals, usage, walk
    scores, per-group affinities), int columns (inverse walk order,
    occupancy, per-group collisions, spread codes, device counts) and
    one failed flag per group, byte columns (penalty and walk flags,
    per-group feasibility, ports) and the spread carries, each column
    C long."""
    d = _chain_dims(p)
    f, i, b, s = _scratch_lens(d["C"], d["G"], d["S"], d["V1"], d["Q"],
                               d["D"])
    return (
        torch.empty(f, dtype=dtype, device=device),
        torch.empty(i, dtype=torch.int32, device=device),
        torch.empty(b, dtype=torch.uint8, device=device),
        torch.empty(s, dtype=dtype, device=device),
    )


def launch_chained_picks(p, used_out, ports_out, devs_out, rows, pulls,
                         scratch) -> None:
    """K3 on the current stream over `ops.batch.prepare_chain` inputs
    (contiguous CUDA tensors, checked by the wrapper)."""
    cols = p["cols"]
    dev = cols[0].device
    b, sp, dl, pre = p["batch"], p["spread"], p["deltas"], p["pre"]
    d = _chain_dims(p)
    ptrs = dict(
        cpu_total=cols[0], mem_total=cols[1], disk_total=cols[2],
        cpu_in=cols[3], mem_in=cols[4], disk_in=cols[5],
        cpu_out=used_out[0], mem_out=used_out[1], disk_out=used_out[2],
        feasible=b.feasible, perm=b.perm, ask_cpu=b.ask_cpu,
        ask_mem=b.ask_mem, ask_disk=b.ask_disk, desired=b.desired_count,
        limit=b.limit, distinct_hosts=b.distinct_hosts, tg_idx=b.tg_idx,
        n_cand=p["n_cand"], wanted=p["wanted"], coll0=p["coll0"],
        affinity=p["affinity"], port_ask=p["port_ask"],
        ports_in=p["port_used0"], ports_out=ports_out,
        dev_ask=p["dev_ask"], devs_in=p["dev_free0"], devs_out=devs_out,
        dev_aff=p["dev_aff"], dev_aff_on=p["dev_aff_on"], occ0=p["occ0"],
        dh_tg=p["dh_tg"], f_scratch=scratch[0], i_scratch=scratch[1],
        b_scratch=scratch[2], s_scratch=scratch[3], out_rows=rows,
        out_pulls=pulls,
    )
    if sp is not None:
        ptrs.update(
            sp_codes=sp.codes, sp_desired=sp.desired, sp_used0=sp.used0,
            sp_prop0=sp.proposed0, sp_clr0=sp.cleared0,
            sp_weight=sp.weight, sp_active=sp.active, sp_even=sp.even,
            sp_group=sp.group,
        )
    if dl is not None:
        ptrs.update(
            evict_rows=dl.evict_rows, evict_cpu=dl.evict_cpu,
            evict_mem=dl.evict_mem, evict_disk=dl.evict_disk,
            evict_coll=dl.evict_coll, penalty_rows=dl.penalty_rows,
        )
    if pre is not None:
        ptrs.update(pre_rows=pre.rows, pre_cpu=pre.cpu, pre_mem=pre.mem,
                    pre_disk=pre.disk)
    args = ChainedPicksArgs()
    for name, _t in ChainedPicksArgs._fields_:
        if name in ptrs:
            t = ptrs[name]
            if t is not None and (t.device != dev or not t.is_contiguous()):
                raise ValueError(f"{name} must be contiguous on {dev}")
            setattr(args, name, _ptr(t))
    for name, value in d.items():
        setattr(args, name, value)
    args.spread_fit = int(p["spread_fit"])
    args.is_f64 = int(cols[0].dtype == torch.float64)
    args.device = dev.index
    _launch("chained_picks", "nk_chained_picks", args, dev)


def launch_patch_rows(col, idx, vals) -> None:
    """K4 on the current stream: col[idx] = vals, out-of-range idx
    dropped."""
    dev = col.device
    args = PatchRowsArgs(
        col.data_ptr(), idx.data_ptr(), vals.data_ptr(),
        col.shape[0], idx.shape[0], int(col.dtype == torch.float64),
        dev.index,
    )
    _launch("patch_rows", "nk_patch_rows", args, dev)


class StormArgs(ctypes.Structure):
    """Mirror of `StormArgs` in csrc/storm_solve.cu."""

    _fields_ = [
        (name, _P) for name in (
            "cpu_total", "mem_total", "disk_total", "cpu_used", "mem_used",
            "disk_used", "feasible", "affinity", "collisions", "perm",
            "limit", "n_cand", "eval_of", "penalty", "ask", "desired",
            "real", "pre_cpu", "pre_mem", "pre_disk", "policy_tput",
            "policy_has", "policy_mig", "scores", "feas",
            "s_walk", "f_walk", "free_cap", "price", "bid_v", "bid_c",
            "has_bid", "accepted", "progress", "pulls0", "out_assigned",
            "out_pulls", "out_round", "out_score", "out_greedy",
            "out_rounds",
        )
    ] + [
        (name, _I) for name in (
            "E", "A", "C", "max_rounds", "spread_fit", "is_f64", "device",
        )
    ]


def launch_storm_solve(inp, cols, *, spread_fit: bool, max_rounds: int):
    """K5 on the current stream over a checked `ops.solve.StormInputs`
    (the three policy fields all tensors for a weighted storm, all None
    otherwise) and the six node columns (contiguous CUDA tensors).
    Allocates the
    outputs and the scratch (two [A, C] score copies and two [A, C]
    byte masks) and returns (assigned, pulls, accept_round, score,
    greedy, rounds) as device tensors."""
    dev = cols[0].device
    dtype = cols[0].dtype
    E, C = inp.feasible.shape
    A = inp.ask.shape[0]
    i32 = torch.int32
    out = dict(
        out_assigned=torch.empty(A, dtype=i32, device=dev),
        out_pulls=torch.empty(A, dtype=i32, device=dev),
        out_round=torch.empty(A, dtype=i32, device=dev),
        out_score=torch.empty(A, dtype=dtype, device=dev),
        out_greedy=torch.empty(A, dtype=i32, device=dev),
        out_rounds=torch.empty(1, dtype=i32, device=dev),
    )
    scratch = dict(
        scores=torch.empty((A, C), dtype=dtype, device=dev),
        feas=torch.empty((A, C), dtype=torch.uint8, device=dev),
        s_walk=torch.empty((A, C), dtype=dtype, device=dev),
        f_walk=torch.empty((A, C), dtype=torch.uint8, device=dev),
        free_cap=torch.empty((C, 3), dtype=dtype, device=dev),
        price=torch.empty(C, dtype=dtype, device=dev),
        bid_v=torch.empty(A, dtype=dtype, device=dev),
        bid_c=torch.empty(A, dtype=i32, device=dev),
        has_bid=torch.empty(A, dtype=i32, device=dev),
        accepted=torch.empty(A, dtype=i32, device=dev),
        progress=torch.empty(max(1, max_rounds), dtype=i32, device=dev),
        pulls0=torch.empty(A, dtype=i32, device=dev),
    )
    ptrs = dict(
        cpu_total=cols[0], mem_total=cols[1], disk_total=cols[2],
        cpu_used=cols[3], mem_used=cols[4], disk_used=cols[5],
        **{name: getattr(inp, name) for name in (
            "feasible", "affinity", "collisions", "perm", "limit",
            "n_cand", "eval_of", "penalty", "ask", "desired", "real",
            "pre_cpu", "pre_mem", "pre_disk",
        )},
        policy_tput=inp.policy_tput_term, policy_has=inp.policy_has_tput,
        policy_mig=inp.policy_mig_term,
        **scratch, **out,
    )
    args = StormArgs()
    for name, t in ptrs.items():
        if t is None:
            continue  # an absent policy field: a null pointer
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {dev}")
        setattr(args, name, t.data_ptr())
    args.E, args.A, args.C = E, A, C
    args.max_rounds = max_rounds
    args.spread_fit = int(spread_fit)
    args.is_f64 = int(dtype == torch.float64)
    args.device = dev.index
    _launch("storm_solve", "nk_storm_solve", args, dev)
    return (out["out_assigned"], out["out_pulls"], out["out_round"],
            out["out_score"], out["out_greedy"], out["out_rounds"][0])


class WalkOnlyArgs(ctypes.Structure):
    """Mirror of `WalkOnlyArgs` in csrc/walk_only.cu."""

    _fields_ = [
        ("feasible", _P), ("scores", _P), ("perm", _P),
        ("s_scratch", _P), ("f_scratch", _P), ("out", _P),
        ("limit", _I), ("n_candidates", _I), ("C", _I),
        ("is_f64", _I), ("device", _I),
    ]


def launch_walk_only(feasible, scores, perm, s_scratch, f_scratch, out, *,
                     limit: int, n_candidates: int) -> None:
    """K6 on the current stream over contiguous CUDA tensors (checked by
    the wrapper): the walk of `scores`/`feasible` in `perm` order into
    the int64[4] `out`."""
    dev = scores.device
    args = WalkOnlyArgs(
        feasible.data_ptr(), scores.data_ptr(), perm.data_ptr(),
        s_scratch.data_ptr(), f_scratch.data_ptr(), out.data_ptr(),
        limit, n_candidates, scores.shape[0],
        int(scores.dtype == torch.float64), dev.index,
    )
    _launch("walk_only", "nk_walk_only", args, dev)


class BatchPicksArgs(ctypes.Structure):
    """Mirror of `BatchPicksArgs` in csrc/batch_picks.cu."""

    _fields_ = [
        (name, _P) for name in (
            "cpu_total", "mem_total", "disk_total", "cpu_used", "mem_used",
            "disk_used", "feasible", "perms", "ask_cpu", "ask_mem",
            "ask_disk", "desired", "limit", "f_scratch", "i_scratch",
            "b_scratch", "out",
        )
    ] + [
        (name, _I) for name in (
            "E", "n_cand", "C", "n_picks", "spread_fit", "is_f64", "device",
        )
    ]


def launch_batch_picks(named, f_scratch, i_scratch, b_scratch, out, *,
                       n_candidates: int, n_picks: int,
                       spread_fit: bool) -> None:
    """K7 on the current stream.  `named` maps the argument names of
    `ops.batch.batch_plan_picks_shared` to contiguous CUDA tensors (the
    wrapper has checked them); one block per row of `perms`."""
    dev = named["cpu_total"].device
    ptrs = dict(
        cpu_total=named["cpu_total"], mem_total=named["mem_total"],
        disk_total=named["disk_total"], cpu_used=named["base_cpu_used"],
        mem_used=named["base_mem_used"], disk_used=named["base_disk_used"],
        feasible=named["feasible"], perms=named["perms"],
        ask_cpu=named["ask_cpu"], ask_mem=named["ask_mem"],
        ask_disk=named["ask_disk"], desired=named["desired_count"],
        limit=named["limit"], f_scratch=f_scratch, i_scratch=i_scratch,
        b_scratch=b_scratch, out=out,
    )
    args = BatchPicksArgs()
    for name, t in ptrs.items():
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {dev}")
        setattr(args, name, t.data_ptr())
    args.E, args.C = named["perms"].shape
    args.n_cand = n_candidates
    args.n_picks = n_picks
    args.spread_fit = int(spread_fit)
    args.is_f64 = int(named["cpu_total"].dtype == torch.float64)
    args.device = dev.index
    _launch("batch_picks", "nk_batch_picks", args, dev)


class CanaryArgs(ctypes.Structure):
    """Mirror of `CanaryArgs` in csrc/canary.cu."""

    _fields_ = [
        ("a", _P), ("out", _P), ("sum", _P),
        ("n", _I), ("threads", _I), ("is_f64", _I), ("device", _I),
    ]


def launch_canary(a, out, total, *, threads: int) -> None:
    """K8 on the current stream: out = a + 1 and total = its sum, one
    block of `threads` (contiguous CUDA tensors of one dtype)."""
    dev = a.device
    for name, t in (("a", a), ("out", out), ("sum", total)):
        if t.device != dev or not t.is_contiguous() or t.dtype != a.dtype:
            raise ValueError(f"{name} must be contiguous {a.dtype} on {dev}")
    args = CanaryArgs(
        a.data_ptr(), out.data_ptr(), total.data_ptr(), a.shape[0], threads,
        int(a.dtype == torch.float64), dev.index,
    )
    _launch("canary", "nk_canary", args, dev)


_SPREAD_PTRS = dict(sp_codes="codes", sp_desired="desired",
                    sp_used0="used0", sp_prop0="proposed0",
                    sp_clr0="cleared0", sp_weight="weight",
                    sp_active="active", sp_even="even", sp_group="group")
_DELTA_PTRS = dict(evict_rows="evict_rows", evict_cpu="evict_cpu",
                   evict_mem="evict_mem", evict_disk="evict_disk",
                   evict_coll="evict_coll", penalty_rows="penalty_rows")
_PRE_PTRS = dict(pre_rows="rows", pre_cpu="cpu", pre_mem="mem",
                 pre_disk="disk")


def _option_ptrs(spread, deltas, pre) -> Dict[str, torch.Tensor]:
    """Pointer fields of the optional per-eval tuples (absent ones stay
    null)."""
    out = {}
    for tup, names in ((spread, _SPREAD_PTRS), (deltas, _DELTA_PTRS),
                       (pre, _PRE_PTRS)):
        if tup is not None:
            out.update({k: getattr(tup, f) for k, f in names.items()})
    return out


def _fill(args: ctypes.Structure, ptrs: Dict[str, torch.Tensor],
          dev) -> None:
    """Set the pointer fields of `args` from contiguous tensors on `dev`
    (None leaves a field null)."""
    fields = {name for name, _t in type(args)._fields_}
    for name, t in ptrs.items():
        if name not in fields:
            raise KeyError(f"{type(args).__name__} has no field {name}")
        if t is None:
            continue
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {dev}")
        setattr(args, name, t.data_ptr())


def _spread_dims(spread) -> Tuple[int, int]:
    return (0, 0) if spread is None else (spread.codes.shape[1],
                                          spread.desired.shape[2])


class ChainedBatchArgs(ctypes.Structure):
    """Mirror of `ChainedBatchArgs` in csrc/chained_batch.cu."""

    _fields_ = [
        (name, _P) for name in (
            "cpu_total", "mem_total", "disk_total", "cpu_in", "mem_in",
            "disk_in", "cpu_out", "mem_out", "disk_out", "feasible", "perm",
            "ask_cpu", "ask_mem", "ask_disk", "desired", "limit",
            "distinct_hosts", "n_cand", "wanted", "collisions", "penalty",
            "affinity", "sp_codes", "sp_desired", "sp_used0", "sp_prop0",
            "sp_clr0", "sp_weight", "sp_active", "sp_even", "sp_group",
            "evict_rows", "evict_cpu", "evict_mem", "evict_disk",
            "evict_coll", "penalty_rows", "pre_rows", "pre_cpu", "pre_mem",
            "pre_disk", "f_scratch", "i_scratch", "b_scratch", "s_scratch",
            "out_rows", "out_pulls",
        )
    ] + [
        (name, _I) for name in (
            "E", "P", "C", "S", "V1", "K", "R", "feas_shared", "spread_fit",
            "is_f64", "device",
        )
    ]


def launch_chained_batch(named, spread, deltas, pre, *, E: int, P: int,
                         C: int, feas_shared: bool, spread_fit: bool,
                         dtype) -> None:
    """K9 on the current stream.  `named` maps the pointer fields of
    `ChainedBatchArgs` (node columns, carry-in and carry-out, the
    per-eval columns and scalars, the outputs) to contiguous CUDA
    tensors or None; the optional tuples come from
    `ops.batch.prepare_batched`.  Allocates the scratch."""
    dev = named["cpu_total"].device
    S, V1 = _spread_dims(spread)
    f, i, b, s = _scratch_lens(C, 1, S, V1)
    ptrs = dict(named, **_option_ptrs(spread, deltas, pre))
    ptrs.update(
        f_scratch=torch.empty(f, dtype=dtype, device=dev),
        i_scratch=torch.empty(i, dtype=torch.int32, device=dev),
        b_scratch=torch.empty(b, dtype=torch.uint8, device=dev),
        s_scratch=torch.empty(s, dtype=dtype, device=dev),
    )
    args = ChainedBatchArgs()
    _fill(args, ptrs, dev)
    args.E, args.P, args.C, args.S, args.V1 = E, P, C, S, V1
    args.K = 0 if deltas is None else deltas.penalty_rows.shape[2]
    args.R = 0 if pre is None else pre.rows.shape[1]
    args.feas_shared = int(feas_shared)
    args.spread_fit = int(spread_fit)
    args.is_f64 = int(dtype == torch.float64)
    args.device = dev.index
    _launch("chained_batch", "nk_chained_batch", args, dev)


class BatchPlanArgs(ctypes.Structure):
    """Mirror of `BatchPlanArgs` in csrc/batch_plan.cu."""

    _fields_ = [
        (name, _P) for name in (
            "cpu_total", "mem_total", "disk_total", "cpu_used", "mem_used",
            "disk_used", "feasible", "perm", "ask_cpu", "ask_mem",
            "ask_disk", "desired", "limit", "distinct_hosts", "n_cand",
            "wanted", "collisions", "penalty", "affinity", "sp_codes",
            "sp_desired", "sp_used0", "sp_prop0", "sp_clr0", "sp_weight",
            "sp_active", "sp_even", "sp_group", "f_scratch", "i_scratch",
            "b_scratch", "s_scratch", "out_rows", "out_pulls",
        )
    ] + [
        (name, _I) for name in (
            "E", "P", "C", "S", "V1", "spread_fit", "is_f64", "device",
        )
    ]


def launch_batch_plan(q, rows, pulls) -> None:
    """K10 on the current stream over `ops.batch.prepare_batched`
    inputs (contiguous CUDA tensors): one block per eval, each with its
    own slice of the scratch allocated here."""
    cols = q["cols"]
    dev = cols[0].device
    dtype = cols[0].dtype
    b = q["batch"]
    E, C = q["E"], q["C"]
    S, V1 = _spread_dims(q["spread"])
    f, i, bb, s = _scratch_lens(C, 1, S, V1)
    ptrs = dict(
        cpu_total=cols[0], mem_total=cols[1], disk_total=cols[2],
        cpu_used=b.base_cpu_used, mem_used=b.base_mem_used,
        disk_used=b.base_disk_used, feasible=b.feasible, perm=b.perm,
        ask_cpu=b.ask_cpu, ask_mem=b.ask_mem, ask_disk=b.ask_disk,
        desired=b.desired_count, limit=b.limit,
        distinct_hosts=b.distinct_hosts, n_cand=q["n_cand"],
        wanted=q["wanted"], collisions=b.base_collisions,
        penalty=b.penalty, affinity=b.affinity_score,
        f_scratch=torch.empty(E * f, dtype=dtype, device=dev),
        i_scratch=torch.empty(E * i, dtype=torch.int32, device=dev),
        b_scratch=torch.empty(E * bb, dtype=torch.uint8, device=dev),
        s_scratch=torch.empty(E * s, dtype=dtype, device=dev),
        out_rows=rows, out_pulls=pulls,
        **_option_ptrs(q["spread"], None, None),
    )
    args = BatchPlanArgs()
    _fill(args, ptrs, dev)
    args.E, args.P, args.C, args.S, args.V1 = E, q["P"], C, S, V1
    args.spread_fit = int(q["spread_fit"])
    args.is_f64 = int(dtype == torch.float64)
    args.device = dev.index
    _launch("batch_plan", "nk_batch_plan", args, dev)


class ScoreAllArgs(ctypes.Structure):
    """Mirror of `ScoreAllArgs` in csrc/score_all.cu."""

    _fields_ = [
        (name, _P) for name in (
            "cpu_total", "mem_total", "disk_total", "cpu_used", "mem_used",
            "disk_used", "feasible", "collisions", "penalty", "affinity",
            "spread", "tput_term", "mig_term", "out_feasible", "out_final",
        )
    ] + [
        ("ask_cpu", _D), ("ask_mem", _D), ("ask_disk", _D),
        ("has_tput", _D),
    ] + [
        (name, _I) for name in (
            "desired", "C", "spread_fit", "is_f64", "device",
        )
    ]


def launch_score_all(cols, out_feasible, out_final, *, tput_term,
                     has_tput: float, mig_term,
                     ask: Tuple[float, float, float], desired: int,
                     spread_fit: bool) -> None:
    """K11 on the current stream.  `cols` maps ScoreInputs column names
    to contiguous CUDA tensors (the wrapper has checked them);
    `tput_term` and `mig_term` are the policy groups' columns, or None
    for an absent group."""
    dev = cols["cpu_total"].device
    args = ScoreAllArgs()
    _fill(args, dict(
        cpu_total=cols["cpu_total"], mem_total=cols["mem_total"],
        disk_total=cols["disk_total"], cpu_used=cols["cpu_used"],
        mem_used=cols["mem_used"], disk_used=cols["disk_used"],
        feasible=cols["feasible"], collisions=cols["collisions"],
        penalty=cols["penalty"], affinity=cols["affinity_score"],
        spread=cols["spread_boost"], tput_term=tput_term, mig_term=mig_term,
        out_feasible=out_feasible, out_final=out_final,
    ), dev)
    args.ask_cpu, args.ask_mem, args.ask_disk = ask
    args.has_tput = has_tput
    args.desired = desired
    args.C = cols["cpu_total"].shape[0]
    args.spread_fit = int(spread_fit)
    args.is_f64 = int(cols["cpu_total"].dtype == torch.float64)
    args.device = dev.index
    _launch("score_all", "nk_score_all", args, dev)


_SC_PTRS = (
    "tot_cpu", "tot_mem", "tot_disk", "use_cpu", "use_mem", "use_disk",
    "coll", "feas_in", "aff_in", "coll0_in", "codes_in", "perm", "ask_cpu",
    "ask_mem", "ask_disk", "desired", "limit", "wanted", "n_cand", "dh",
    "evict_rows", "evict_cpu", "evict_mem", "evict_disk", "evict_coll",
    "pen_rows", "pre_rows", "pre_cpu", "pre_mem", "pre_disk", "sp_desired",
    "sp_used0", "sp_prop0", "sp_clr0", "sp_weight", "sp_active", "sp_even",
    "off", "dead", "prop", "clr", "ev_oh", "oh", "rows_out", "pulls_out",
    "final_g", "feas_g", "g_bad", "g_nd", "g_fin", "final_l", "feas_l",
    "s_p", "f_p", "rec_bad", "rec_nd", "rec_fin", "oh_l", "ev_oh_l",
)
_SC_INTS = ("E", "P", "C", "Cl", "D", "shard", "K", "R", "S", "V1", "e", "k",
            "stage", "spread_fit", "is_f64", "device")


class ShardedChainArgs(ctypes.Structure):
    """Mirror of `ShardedChainArgs` in csrc/sharded_chain.cu."""

    _fields_ = [(name, _P) for name in _SC_PTRS] + [
        (name, _I) for name in _SC_INTS]


class ShardedChainStages:
    """K12's stages for one chain (`parallel/mesh.py _drive`): one args
    block per local shard and one for the process, filled once; a
    launch sets the stage, eval and pick and calls the library on the
    current stream.  `launched` counts the kernel launches."""

    BEGIN, PROLOGUE, SCORE, WALK_BAD, WALK_ND, WALK_FIN, COMMIT, ADVANCE = range(8)

    def __init__(self, c) -> None:
        lib = library("sharded_chain")
        self._fn = lib.nk_sharded_chain
        self._fn.argtypes = [ctypes.POINTER(ShardedChainArgs), _P]
        self._fn.restype = _I
        self._err = lib.nk_error_string
        dev = c.final_g.device
        code = lib.nk_set_device(dev.index)
        if code != 0:
            raise RuntimeError(f"nk_set_device: {self._err(code).decode()}")
        self._stream = _P(torch.cuda.current_stream(dev).cuda_stream)
        self.launched = 0
        sp = c.spread
        common = dict(
            perm=c.perm, ask_cpu=c.ask[0], ask_mem=c.ask[1], ask_disk=c.ask[2],
            desired=c.desired, limit=c.limit, wanted=c.wanted,
            n_cand=c.n_cand, dh=c.dh, evict_rows=c.ev_rows,
            evict_cpu=c.ev_vals[0], evict_mem=c.ev_vals[1],
            evict_disk=c.ev_vals[2], evict_coll=c.ev_coll,
            pen_rows=c.pen_rows, pre_rows=c.pre_rows, pre_cpu=c.pre_vals[0],
            pre_mem=c.pre_vals[1], pre_disk=c.pre_vals[2],
            sp_desired=c.sp_desired if sp else None,
            sp_used0=c.sp_used0 if sp else None,
            sp_prop0=c.sp_prop0 if sp else None,
            sp_clr0=c.sp_clr0 if sp else None,
            sp_weight=c.sp_weight if sp else None,
            sp_active=c.sp_active if sp else None,
            sp_even=c.sp_even if sp else None,
            off=c.off, dead=c.dead, prop=c.prop, clr=c.clr, ev_oh=c.ev_oh,
            oh=c.oh, rows_out=c.rows, pulls_out=c.pulls, final_g=c.final_g,
            feas_g=c.feas_g, g_bad=c.g_bad, g_nd=c.g_nd, g_fin=c.g_fin,
        )
        dims = dict(E=c.E, P=c.P, C=c.C, Cl=c.size, D=c.D, K=c.K, R=c.R,
                    S=c.S, V1=c.V1, spread_fit=int(c.spread_fit),
                    is_f64=int(c.dtype == torch.float64), device=dev.index)

        def block(sh):
            args = ShardedChainArgs()
            ptrs = dict(common)
            if sh is not None:
                ptrs.update(
                    tot_cpu=sh.tot[0], tot_mem=sh.tot[1], tot_disk=sh.tot[2],
                    use_cpu=sh.use[0], use_mem=sh.use[1], use_disk=sh.use[2],
                    coll=sh.coll, feas_in=sh.feas, aff_in=sh.aff,
                    coll0_in=sh.coll0, codes_in=sh.codes, final_l=sh.final_l,
                    feas_l=sh.feas_l, s_p=sh.s_p, f_p=sh.f_p,
                    rec_bad=sh.rec_bad, rec_nd=sh.rec_nd, rec_fin=sh.rec_fin,
                    oh_l=sh.oh_l, ev_oh_l=sh.ev_oh_l)
            _fill(args, ptrs, dev)
            for name, v in dims.items():
                setattr(args, name, v)
            args.shard = -1 if sh is None else sh.s
            return args

        self._proc = block(None)
        self._args = {id(sh): block(sh) for sh in c.shards}

    def _go(self, args, stage: int, e: int, k: int = 0) -> None:
        args.stage = stage
        args.e = e
        args.k = k
        code = self._fn(ctypes.byref(args), self._stream)
        if code != 0:
            raise RuntimeError(
                f"nk_sharded_chain stage {stage} launch failed: "
                f"{self._err(code).decode()} ({code})")
        self.launched += 1

    def begin(self, c, e):
        self._go(self._proc, self.BEGIN, e)

    def prologue(self, c, sh, e):
        self._go(self._args[id(sh)], self.PROLOGUE, e)

    def score(self, c, sh, e, k):
        self._go(self._args[id(sh)], self.SCORE, e, k)

    def walk_bad(self, c, sh, e):
        self._go(self._args[id(sh)], self.WALK_BAD, e)

    def walk_nd(self, c, sh, e):
        self._go(self._args[id(sh)], self.WALK_ND, e)

    def walk_fin(self, c, sh, e):
        self._go(self._args[id(sh)], self.WALK_FIN, e)

    def commit(self, c, sh, e, k):
        self._go(self._args[id(sh)], self.COMMIT, e, k)

    def advance(self, c, e, k):
        self._go(self._proc, self.ADVANCE, e, k)


class PatchRowsShardedArgs(ctypes.Structure):
    """Mirror of `PatchRowsShardedArgs` in csrc/patch_rows_sharded.cu."""

    _fields_ = [
        ("col", _P), ("idx", _P), ("vals", _P),
        ("lo", _I), ("size", _I), ("W", _I), ("is_f64", _I), ("device", _I),
    ]


def launch_patch_rows_sharded(col, idx, vals, lo: int) -> None:
    """K13 on the current stream for one shard: col[idx - lo] = vals
    where 0 <= idx - lo < size."""
    dev = col.device
    args = PatchRowsShardedArgs(
        col.data_ptr(), idx.data_ptr(), vals.data_ptr(), lo, col.shape[0],
        idx.shape[0], int(col.dtype == torch.float64), dev.index,
    )
    _launch("patch_rows_sharded", "nk_patch_rows_sharded", args, dev)


# the shard pointers K15 takes by value (kMaxShards in its source)
HOSTLOCAL_MAX_SHARDS = 64


class PatchRowsHostlocalArgs(ctypes.Structure):
    """Mirror of `PatchRowsHostlocalArgs` in csrc/patch_rows_hostlocal.cu."""

    _fields_ = [
        ("shards", _P * HOSTLOCAL_MAX_SHARDS), ("idx", _P), ("vals", _P),
        ("L", _I), ("size", _I), ("w", _I), ("is_f64", _I), ("device", _I),
    ]


def launch_patch_rows_hostlocal(shards, idx, vals) -> None:
    """K15 on the current stream for this process's L shards at once:
    shards[l][idx[l]] = vals[l] where 0 <= idx[l] < size."""
    L = len(shards)
    if L > HOSTLOCAL_MAX_SHARDS:
        raise RuntimeError(f"K15 takes at most {HOSTLOCAL_MAX_SHARDS} local "
                           f"shards, got {L}")
    dev = shards[0].device
    ptrs = (_P * HOSTLOCAL_MAX_SHARDS)(*[t.data_ptr() for t in shards])
    args = PatchRowsHostlocalArgs(
        ptrs, idx.data_ptr(), vals.data_ptr(), L, shards[0].shape[0],
        idx.shape[1], int(shards[0].dtype == torch.float64), dev.index,
    )
    _launch("patch_rows_hostlocal", "nk_patch_rows_hostlocal", args, dev)


_SS_PTRS = (
    "cpu_total", "mem_total", "disk_total", "cpu_used", "mem_used",
    "disk_used", "pre_cpu", "pre_mem", "pre_disk", "feasible", "affinity",
    "collisions", "penalty", "policy_tput", "policy_mig", "perm", "limit",
    "n_cand", "eval_of", "ask", "desired", "real", "policy_has", "scores_l",
    "feas_l", "free_l", "price_l", "rec_max", "rec_idx", "cand", "terms",
    "m_term", "score_term", "scores_g", "feas_g", "s_walk", "f_walk", "gmax",
    "best_c", "reads", "m_at_bid", "score_read", "rows0", "pulls0", "bid_c",
    "bid_v", "has_bid", "accepted", "assigned", "acc_round", "progress",
    "out_pulls", "out_score", "out_rounds",
)
_SS_INTS = ("E", "A", "C", "S", "D", "shard", "lo", "rnd", "max_rounds",
            "stage", "spread_fit", "is_f64", "device")


class StormShardedArgs(ctypes.Structure):
    """Mirror of `StormShardedArgs` in csrc/storm_sharded.cu."""

    _fields_ = [(name, _P) for name in _SS_PTRS] + [
        (name, _I) for name in _SS_INTS]


class StormShardedStages:
    """K14's stages for one solve (`ops/solve.py _drive_storm`): one args
    block per local shard and one for the process, filled once; a launch
    sets the stage and round and calls the library on the current
    stream.  `launched` counts the kernel launches."""

    (SCORE, WALK, BID, CAND, READ, BIDS, BUDGET, ACCEPT, DEBIT, EPI_READ,
     FINISH) = range(11)

    def __init__(self, st) -> None:
        lib = library("storm_sharded")
        self._fn = lib.nk_storm_sharded
        self._fn.argtypes = [ctypes.POINTER(StormShardedArgs), _P]
        self._fn.restype = _I
        self._err = lib.nk_error_string
        dev = st.gmax.device
        code = lib.nk_set_device(dev.index)
        if code != 0:
            raise RuntimeError(f"nk_set_device: {self._err(code).decode()}")
        self._stream = _P(torch.cuda.current_stream(dev).cuda_stream)
        self.launched = 0
        common = dict(
            perm=st.perm, limit=st.limit, n_cand=st.n_cand,
            eval_of=st.eval_of, ask=st.ask, desired=st.desired, real=st.real,
            policy_has=st.has_tput, scores_g=st.scores_g, feas_g=st.feas_g,
            s_walk=st.s_walk, f_walk=st.f_walk, gmax=st.gmax,
            best_c=st.best_c, reads=st.reads, m_at_bid=st.m_at_bid,
            score_read=st.score_read, rows0=st.rows0, pulls0=st.pulls0,
            bid_c=st.bid_c, bid_v=st.bid_v, has_bid=st.has_bid,
            accepted=st.accepted, assigned=st.assigned,
            acc_round=st.acc_round, progress=st.progress,
            out_pulls=st.out_pulls, out_score=st.out_score,
            out_rounds=st.out_rounds,
        )
        dims = dict(E=st.E, A=st.A, C=st.C, S=st.S, D=st.D,
                    max_rounds=st.max_rounds, spread_fit=int(st.spread_fit),
                    is_f64=int(st.dtype == torch.float64), device=dev.index)

        def block(sh):
            args = StormShardedArgs()
            ptrs = dict(common)
            if sh is not None:
                ptrs.update(
                    cpu_total=sh.tot[0], mem_total=sh.tot[1],
                    disk_total=sh.tot[2], cpu_used=sh.used[0],
                    mem_used=sh.used[1], disk_used=sh.used[2],
                    pre_cpu=sh.pre[0], pre_mem=sh.pre[1], pre_disk=sh.pre[2],
                    feasible=sh.feasible, affinity=sh.affinity,
                    collisions=sh.collisions, penalty=sh.penalty,
                    policy_tput=sh.tput, policy_mig=sh.mig,
                    scores_l=sh.scores, feas_l=sh.feas, free_l=sh.free,
                    price_l=sh.price, rec_max=sh.rec_max, rec_idx=sh.rec_idx,
                    cand=sh.cand, terms=sh.terms, m_term=sh.m_term,
                    score_term=sh.score_term)
            _fill(args, ptrs, dev)
            for name, v in dims.items():
                setattr(args, name, v)
            args.shard = -1 if sh is None else sh.s
            args.lo = 0 if sh is None else sh.lo
            return args

        self._proc = block(None)
        self._args = {id(sh): block(sh) for sh in st.shards}

    def _go(self, args, stage: int, rnd: int = 0) -> None:
        args.stage = stage
        args.rnd = rnd
        code = self._fn(ctypes.byref(args), self._stream)
        if code != 0:
            raise RuntimeError(
                f"nk_storm_sharded stage {stage} launch failed: "
                f"{self._err(code).decode()} ({code})")
        self.launched += 1

    def score(self, st, sh):
        self._go(self._args[id(sh)], self.SCORE)

    def walk(self, st):
        self._go(self._proc, self.WALK)

    def bid(self, st, sh, rnd):
        self._go(self._args[id(sh)], self.BID, rnd)

    def cand(self, st, sh):
        self._go(self._args[id(sh)], self.CAND)

    def read(self, st, sh, rnd):
        self._go(self._args[id(sh)], self.READ, rnd)

    def bids(self, st, rnd):
        self._go(self._proc, self.BIDS, rnd)

    def budget(self, st, sh):
        self._go(self._args[id(sh)], self.BUDGET)

    def accept(self, st, rnd):
        self._go(self._proc, self.ACCEPT, rnd)

    def debit(self, st, sh):
        self._go(self._args[id(sh)], self.DEBIT)

    def epi_read(self, st, sh):
        self._go(self._args[id(sh)], self.EPI_READ)

    def finish(self, st, rounds):
        self._go(self._proc, self.FINISH, rounds)
