"""Time the PyTorch port's prefix-walk kernels on the card — K2 (the
per-eval stack's look-ahead, `plan_picks_cuda`), K7 (the bridge's
`ScoreBatch`, `batch_plan_picks_shared_cuda`), K9 (the bench's chained
planner, `launch_chained_plan`), K10 (the bench's independent planner,
`launch_batch_plan`), K1 (the per-eval select,
`score_and_select_packed`) and K6 (the preemption walk,
`walk_only_cuda`) — for one or more checkouts of the repo, so that two
commits are compared on the same card in one run:

    python3 picks_timing.py [TREE ...]

Each TREE (default: the directory of this script) is timed in a process
of its own, in the order given: pass a parent around its change as
``PARENT CHANGE CHANGE PARENT``.  The shapes are chip_smoke.py's timing
phase's, in f64, over a 16,384-row arena with 10,000 candidates unless
named: K2 on the "plain" case at limit 14 and P = 16 (`time_kernels`),
K7 on E = 64 evals x P = 10 of the "bridge" case (`time_batch_kernel`);
K9 at the bench's kernel-only shape (its 2,000-node world: a 2,048-row
arena, 2,000 candidates, E = 64 x P = 10) and at the 16k arena
(`batched_case` "plain", E = 64 x P = 10; `time_batched_kernels`), K10
over the same two launches' inputs; K1
at limit 14 on the "mixed" case and with both policy groups unlimited
(`time_kernels`, `time_policy_select`); and the cases whose walks run
long: K2 "out_of_room" (limit 14, P = 16), K7 "tight" and "fit_nowhere",
K1 "div0" (40 feasible nodes, limit 14); K6 on a "spliced" score
vector of the 16,384-row arena (13,107 candidates) at limit 14, as the
preemption loop launches it (no feasible count where the wrapper takes
the flag), and unlimited (`time_walk_kernel`).  K1 and K6 run the
launch shape their rule takes (their grid where limit >= n_candidates,
their prefix walk elsewhere); to time a shape off the rule, pass as a
TREE a copy of the port under `build/` with the rule (`takes_grid` in
csrc/walk_grid.cuh) edited.
For each tree and case it checks the kernel's output against its twin
on the card once, then prints one JSON line with, per case:

- ``ms``: the device time of one launch, from `torch.profiler` (CUPTI)
  over 100 calls after 10 (K9 50): the mean device time of the kernels
  whose name holds the kernel's (``plan_picks_kernel``,
  ``batch_picks_kernel``, ``chain`` for K9, ``batch_plan`` for K10,
  ``select`` for K1, ``walk_only`` for K6);
- ``call_ms``: the CUDA-event mean of 200 calls after 10 (K9 50) as
  chip_smoke.py times them (where a call's host work outlasts its
  kernel, this is the host's rate: K7's wrapper reads its limits'
  minimum, a device-to-host copy, every call);
- ``launches``: the wrapper's count a call over the timed calls;
- ``pulls``: the positions the walks consumed, K2's, K9's, K10's, K1's
  and K6's from their own output, K7's from K2 run one eval at a time.

The card's name and power limit come first, as nvidia-smi gives them.
Exits 1 without a card, or if any tree's run fails."""
import inspect
import json
import os
import subprocess
import sys

C, N_CAND = 16_384, 10_000  # chip_smoke.py's C_CHECK, N_CAND_CHECK
K2_CASES = (("plain", 7001), ("out_of_room", 7003))
K2_LIMIT, K2_P = 14, 16
K7_CASES = (("bridge", 9200), ("tight", 9201), ("fit_nowhere", 9202))
K7_E, K7_P = 64, 10
K9_E, K9_P = 64, 10
# (case, score_case scenario, seed, limit): the path's select, the
# weighted select (both policy groups) and a limited walk that runs long
K1_CASES = (("limit14_mixed", "mixed", 7000, 14),
            ("policy_both", "both", 7002, 2**31 - 1),
            ("long_div0", "div0", 7003, 14))
# (case, walk_case scenario, seed, limit): the preemption walk's select
# and an unlimited one (a group with affinities, spreads or policy terms)
K6_CASES = (("limit14_spliced", "spliced", 9800, 14),
            ("unlimited_spliced", "spliced", 9801, 2**31 - 1))
N, WARMUP = 200, 10


def _time_ms(fn, n: int = N, warmup: int = WARMUP) -> float:
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


def _profiled_ms(fn, kernel: str, n: int = 100, warmup: int = WARMUP):
    """Mean device ms of the kernels whose name holds `kernel` over `n`
    calls, from the profiler's CUPTI trace (None if it recorded none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total_us, count = 0.0, 0
    for e in prof.key_averages():
        if kernel in e.key:
            total_us += getattr(e, "device_time_total",
                                getattr(e, "cuda_time_total", 0.0))
            count += e.count
    return total_us / count / 1e3 if count and total_us > 0 else None


def _k2_args(scenario: str, seed: int, cuda):
    import torch

    from nomad_tpu_torch.ops.cases import batch_case
    from nomad_tpu_torch.state.convert import batch_inputs_from_numpy

    cols, inp = batch_case(seed, C, N_CAND, scenario, K2_LIMIT, K2_P)
    t = {k: torch.from_numpy(v).to(cuda) for k, v in cols.items()}
    return (t["cpu_total"], t["mem_total"], t["disk_total"],
            batch_inputs_from_numpy(inp, cuda), N_CAND, K2_P, False)


def _k7_pulls(case, kw, cuda) -> int:
    """The positions K7's walks consume: K2 over each eval in turn."""
    import numpy as np

    from nomad_tpu_torch.ops import batch as tbatch
    from nomad_tpu_torch.state.convert import batch_inputs_from_numpy

    pulls = 0
    for k in range(K7_E):
        inp = batch_inputs_from_numpy(dict(
            feasible=case["feasible"], base_cpu_used=case["base_cpu_used"],
            base_mem_used=case["base_mem_used"],
            base_disk_used=case["base_disk_used"],
            base_collisions=np.zeros(C, np.int32),
            penalty=np.zeros(C, bool), affinity_score=np.zeros(C),
            perm=case["perms"][k], ask_cpu=case["ask_cpu"][k],
            ask_mem=case["ask_mem"][k], ask_disk=case["ask_disk"][k],
            desired_count=case["desired_count"][k], limit=case["limit"][k],
            distinct_hosts=False,
        ), cuda)
        pulls += int(tbatch.plan_picks_cuda(
            kw["cpu_total"], kw["mem_total"], kw["disk_total"], inp, N_CAND,
            K7_P)[1].sum())
    return pulls


def _timed(wrapper, call, kernel: str, n: int = N) -> dict:
    before = wrapper.launches
    call_ms = _time_ms(call, n)
    launches = (wrapper.launches - before) / (n + WARMUP)
    return {"ms": _profiled_ms(call, kernel, min(n, 100)),
            "call_ms": call_ms, "launches": launches}


def _k9_cases(cuda):
    """K9's prepared inputs: the bench's kernel-only launch and the 16k
    arena's, as chip_smoke.py's time_batched_kernels builds them."""
    import numpy as np
    import torch

    from nomad_tpu_torch import bench as tbench
    from nomad_tpu_torch.ops import batch as tbatch
    from nomad_tpu_torch.ops.cases import batched_case
    from nomad_tpu_torch.state.convert import batched_case_to_torch

    world = tbench.kernel_world(2000)
    inp = tbench.kernel_inputs(world, K9_E)
    cols = [torch.from_numpy(np.ascontiguousarray(c)).to(cuda)
            for c in inp["cols"]]
    perms = tbench.kernel_perms(world, list(range(K9_E)))
    batch = tbatch.prepare_batched(
        *cols, tbatch.BatchInputs(perm=perms, **inp["shared"]),
        inp["n_cand"], tbench.TG_COUNT)["batch"]
    yield "k9_bench", tbatch.prepare_batched(*cols, batch, inp["n_cand"],
                                             tbench.TG_COUNT)
    cols16, kw16 = batched_case(9600, C, N_CAND, "plain", K9_E, K9_P)
    args, kwargs = batched_case_to_torch(cols16, kw16, cuda)
    yield "k9_arena16k", tbatch.prepare_batched(*args, **kwargs)


def _k1_input(scenario: str, seed: int, limit: int, cuda):
    from nomad_tpu_torch.ops.cases import policy_score_case, score_case
    from nomad_tpu_torch.state.convert import score_inputs_from_numpy

    if scenario == "both":
        case = policy_score_case(seed, C, N_CAND, scenario, limit)
    else:
        case = score_case(seed, C, N_CAND, scenario, limit)
    return score_inputs_from_numpy(case, cuda)


def measure(tree: str) -> dict:
    """The timings of `tree`'s K2, K7, K9, K10, K1 and K6, in this
    process."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch

    from nomad_tpu_torch.ops import _cuda
    from nomad_tpu_torch.ops import batch as tbatch
    from nomad_tpu_torch.ops import score as tscore
    from nomad_tpu_torch.ops.cases import batch_shared_case, walk_case
    from nomad_tpu_torch.state.convert import batch_shared_inputs_from_numpy

    if not tbatch.__file__.startswith(tree + os.sep):
        raise RuntimeError(f"imported {tbatch.__file__}, not {tree}'s port")
    cuda = torch.device("cuda", 0)
    _cuda.load(["plan_picks", "batch_picks", "chained_batch",
                "score_select", "batch_plan", "walk_only"])
    out = {"tree": tree}
    for scenario, seed in K2_CASES:
        args = _k2_args(scenario, seed, cuda)
        kern = tbatch.plan_picks_cuda(*args).cpu()
        twin = torch.stack(tbatch.run_picks(*args)).cpu()
        if not torch.equal(kern, twin):
            raise RuntimeError(f"K2 {scenario}: the kernel differs from its twin")
        out[f"k2_{scenario}"] = dict(
            _timed(tbatch.plan_picks_cuda,
                   lambda args=args: tbatch.plan_picks_cuda(*args),
                   "plan_picks_kernel"),
            pulls=int(kern[1].sum()))
    for scenario, seed in K7_CASES:
        case = batch_shared_case(seed, C, N_CAND, scenario, K7_E, K7_P)
        kw = batch_shared_inputs_from_numpy(case, cuda)
        kern = tbatch.batch_plan_picks_shared_cuda(**kw).cpu()
        twin = tbatch.batch_plan_picks_shared_twin(**kw).cpu()
        if not torch.equal(kern, twin):
            raise RuntimeError(f"K7 {scenario}: the kernel differs from its twin")
        out[f"k7_{scenario}"] = dict(
            _timed(tbatch.batch_plan_picks_shared_cuda,
                   lambda kw=kw: tbatch.batch_plan_picks_shared_cuda(**kw),
                   "batch_picks_kernel"),
            pulls=_k7_pulls(case, kw, cuda))
    for name, q in _k9_cases(cuda):
        rows, pulls = (t.cpu() for t in tbatch.launch_chained_plan(q))
        twin = tbatch.chained_picks_twin(tbatch.batched_as_chain(q))
        if not (torch.equal(rows, twin[0].cpu())
                and torch.equal(pulls, twin[1].cpu())):
            raise RuntimeError(f"K9 {name}: the kernel differs from its twin")
        out[name] = dict(
            _timed(tbatch.chained_plan_picks_cuda,
                   lambda q=q: tbatch.launch_chained_plan(q), "chain", n=50),
            pulls=int(pulls.sum()))
        k10 = name.replace("k9", "k10")
        rows, pulls = (t.cpu() for t in tbatch.launch_batch_plan(q))
        if not torch.equal(rows, tbatch.batch_plan_rows_twin(q).cpu()):
            raise RuntimeError(f"K10 {k10}: the kernel differs from its twin")
        out[k10] = dict(
            _timed(tbatch.batch_plan_picks_cuda,
                   lambda q=q: tbatch.launch_batch_plan(q), "batch_plan",
                   n=50),
            pulls=int(pulls.sum()))
    for name, scenario, seed, limit in K1_CASES:
        k1 = _k1_input(scenario, seed, limit, cuda)
        twin = tscore.score_and_select_twin(k1)
        want = (int(twin[0]), float(twin[1]), int(twin[2]), int(twin[3]))
        got = tscore.score_select_cuda(k1)
        if (int(got.out_i[0]), float(got.best[0]), int(got.out_i[2]),
                int(got.out_i[1])) != want:
            raise RuntimeError(f"K1 {name}: the kernel differs from its twin")
        out[f"k1_{name}"] = dict(
            _timed(tscore.score_select_cuda,
                   lambda k1=k1: tscore.score_and_select_packed(k1), "select"),
            pulls=want[3])
    # the count flag where the tree's wrapper has it (the preemption
    # loop's call); a tree without it always counts
    flag = (False,) if "count" in inspect.signature(
        tscore.walk_only_cuda).parameters else ()
    for name, scenario, seed, limit in K6_CASES:
        case = walk_case(seed, C, scenario, limit)
        k6 = (torch.from_numpy(case["feasible"]).to(cuda),
              torch.from_numpy(case["scores"]).to(cuda),
              torch.from_numpy(case["perm"]).to(cuda), limit,
              case["n_candidates"])
        twin = tscore.limited_walk_argmax(*k6)
        got = tscore.walk_only_cuda(*k6, *flag).cpu().tolist()
        if (got[0], got[2]) != (int(twin[0]), int(twin[3])):
            raise RuntimeError(f"K6 {name}: the kernel differs from its twin")
        out[f"k6_{name}"] = dict(
            _timed(tscore.walk_only_cuda,
                   lambda k6=k6: tscore.walk_only_cuda(*k6, *flag),
                   "walk_only"),
            pulls=got[2])
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
                              "--one", tree],
                             capture_output=True, text=True, cwd=tree)
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
