"""Time the unsharded usage mirror's delta flush (kernel K4) and the device
supervisor's canary probe (kernel K8) of the PyTorch port on the card,
for one or more checkouts of the repo, so that two commits are compared
on the same card in one run:

    python3 mirror_probe_timing.py [TREE ...]

Each TREE (default: the directory of this script) is timed in a process
of its own, in the order given: pass a parent around its change as
``PARENT CHANGE CHANGE PARENT``.  The shapes are chip_smoke.py's timing
phase's: K4 at W = 128 staged rows (80 dirty) of a 16,384-row column, K8
on ones(8) in f64.  For each tree it prints one JSON line, in ms:

- ``flush_host_ms``: the tree's own `BatchWorker._device_columns_locked`
  making one delta flush of 80 dirty rows into its mirror of three
  16,384-row usage columns, on a stand-in worker (the worker's stream,
  no Server), from the dirty rows to `torch.cuda.synchronize()`: host
  clock, mean of 200 after 20; ``flush_launches`` and
  ``flush_copies``: its K4 launches and host-to-device copies a flush
  (the worker's uploads and `RowPatch`'s staging copies);
- ``probe_host_ms``: the tree's own `DeviceSupervisor._default_canary()`
  after `prepare()`, from the call to its answer (16.0): host clock,
  mean of 1,000 after 20; ``probe_once_ms`` the same through
  `probe_once()`, with the bounded call's thread handoff;
- CUDA-event means of 1,000 calls after 20: ``k4_wrapper_ms``, the
  per-column entry point (`patch_rows_cuda`), and ``k4_library_ms``,
  `index_copy_` of the valid rows; ``k8_call_ms``, `canary_cuda` on
  device tensors, and ``k8_library_ms``, `torch.add(a, 1).sum()`; where
  the tree binds them, ``k4_launch_ms``, the bound one-column launch,
  ``k4_flush3_ms``, the bound three-column launch a flush makes,
  against ``k4_library3_ms``, three `index_copy_` calls, and
  ``k8_launch_ms``, the bound probe's launch.

The card's name and power limit come first, as nvidia-smi gives them.
Exits 1 without a card, or if any tree's run fails."""
import json
import os
import subprocess
import sys
import time
import types

C = 16_384  # chip_smoke.py's C_CHECK
WIDTH, DIRTY = 128, 80  # chip_smoke.py's K4 timing shape
CALLS = 1000


def _time_ms(fn, n: int = CALLS, warmup: int = 20) -> float:
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


def _host_ms(fn, n: int, warmup: int = 20) -> float:
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n * 1e3


class _Store:
    """The store's dirty-row log as the mirror reads it: every call
    after the full sync returns the same dirty rows."""

    def __init__(self, rows) -> None:
        self.gen = 0
        self.rows = list(rows)

    def usage_delta_since(self, gen):
        self.gen += 1
        return self.gen, ([] if gen < 0 else self.rows)


def _flush(tree_batch_worker, rng, cuda) -> dict:
    """The tree's unsharded delta flush on a stand-in worker."""
    import numpy as np
    import torch

    from nomad_tpu_torch.ops import batch as tbatch

    rows = np.sort(rng.choice(C, DIRTY, replace=False))
    table = types.SimpleNamespace(epoch=0, topo_generation=0, capacity=C)
    for name in ("cpu_total", "mem_total", "disk_total", "cpu_used",
                 "mem_used", "disk_used"):
        setattr(table, name, rng.uniform(0.0, 1e4, C))
    stream = torch.cuda.Stream(cuda)
    w = types.SimpleNamespace(
        _backend_epoch=0, store=_Store(rows), _usage_cache=None,
        stream=stream, device=cuda, _input_cache_hits=0,
        _input_cache_misses=0, server=None)
    cls = tree_batch_worker.BatchWorker
    w._upload = cls._upload.__get__(w)
    uploads = [0]
    upload = w._upload

    def counted(arr):
        uploads[0] += 1
        return upload(arr)

    w._upload = counted

    def flush():
        with torch.cuda.stream(stream):
            cls._device_columns_locked(w, table)
        torch.cuda.synchronize()

    flush()  # the full sync
    launches = tbatch.patch_rows_cuda.launches
    staged = tbatch.RowPatch.copies
    uploads[0] = 0
    out = {"flush_host_ms": _host_ms(flush, 200)}
    out["flush_launches"] = (tbatch.patch_rows_cuda.launches - launches) / 220
    out["flush_copies"] = (uploads[0] + tbatch.RowPatch.copies - staged) / 220
    for col, host in zip(w._usage_cache["cols"][3:],
                         (table.cpu_used, table.mem_used, table.disk_used)):
        if not np.array_equal(col.cpu().numpy(), host):
            raise RuntimeError("the mirror differs from its host columns")
    return out


def measure(tree: str) -> dict:
    """The timings of `tree`'s K4 and K8 paths, in this process."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    from nomad_tpu_torch.device import DeviceSupervisor
    from nomad_tpu_torch.ops import _cuda
    from nomad_tpu_torch.ops import batch as tbatch
    from nomad_tpu_torch.ops import canary as tcanary
    from nomad_tpu_torch.server import batch_worker

    if not tbatch.__file__.startswith(tree + os.sep):
        raise RuntimeError(f"imported {tbatch.__file__}, not {tree}'s port")
    cuda = torch.device("cuda", 0)
    _cuda.load([n for n in _cuda.SOURCES
                if n.startswith("patch_rows") or n == "canary"])
    out = {"tree": tree}
    rng = np.random.default_rng(9001)
    out.update(_flush(batch_worker, rng, cuda))

    col = torch.from_numpy(rng.uniform(0.0, 1e4, C)).to(cuda)
    idx = np.full(WIDTH, C, np.int32)
    idx[:DIRTY] = np.sort(rng.choice(C, DIRTY, replace=False))
    idx_t = torch.from_numpy(idx).to(cuda)
    vals = torch.from_numpy(rng.uniform(0.0, 1e4, WIDTH)).to(cuda)
    idx_valid = idx_t[:DIRTY].long()
    vals_valid = vals[:DIRTY].contiguous()
    out["k4_wrapper_ms"] = _time_ms(
        lambda: tbatch.patch_rows_cuda(col, idx_t, vals))
    out["k4_library_ms"] = _time_ms(
        lambda: col.index_copy_(0, idx_valid, vals_valid))
    if hasattr(tbatch, "_OneShard"):  # K4 bound over plain columns
        vals1 = vals.unsqueeze(0)
        patch = tbatch.RowPatch(None, (col,))
        ptrs = (idx_t.data_ptr(), vals1.data_ptr(), WIDTH)
        out["k4_launch_ms"] = _time_ms(lambda: patch.launch(*ptrs))
        cols = tuple(col.clone() for _ in range(3))
        vals3 = torch.from_numpy(rng.uniform(0.0, 1e4, (3, WIDTH))).to(cuda)
        patch3 = tbatch.RowPatch(None, cols)
        ptrs3 = (idx_t.data_ptr(), vals3.data_ptr(), WIDTH)
        out["k4_flush3_ms"] = _time_ms(lambda: patch3.launch(*ptrs3))
        valid3 = [v[:DIRTY].contiguous() for v in vals3]

        def library3():
            for c, v in zip(cols, valid3):
                c.index_copy_(0, idx_valid, v)

        out["k4_library3_ms"] = _time_ms(library3)

    a = torch.ones(8, dtype=torch.float64, device=cuda)
    out["k8_call_ms"] = _time_ms(lambda: tcanary.canary_cuda(a))
    out["k8_library_ms"] = _time_ms(lambda: torch.add(a, 1).sum())
    if hasattr(tcanary, "CanaryProbe"):
        probe = tcanary.CanaryProbe(cuda)
        out["k8_launch_ms"] = _time_ms(probe.launch)
        probe.close()
    sup = DeviceSupervisor(expected=True, device=cuda, probe_interval_s=3600.0)
    sup.prepare()
    answers = set()
    out["probe_host_ms"] = _host_ms(
        lambda: answers.add(sup._default_canary()), 1000)
    out["probe_once_ms"] = _host_ms(lambda: answers.add(sup.probe_once()),
                                    1000)
    getattr(sup, "close", sup.stop)()
    if answers != {16.0, True}:
        raise RuntimeError(f"the probes answered {answers}")
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
