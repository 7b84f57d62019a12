"""Time the sharded usage mirror's row patch of the PyTorch port (kernels
K13 and K15) on the card, for one or more checkouts of the repo, so that
two commits are compared on the same card in one run:

    python3 row_patch_timing.py [TREE ...]

Each TREE (default: the directory of this script) is timed in a process
of its own, in the order given: pass a parent around its change as
``PARENT CHANGE CHANGE PARENT``.  The shapes are chip_smoke.py's timing
phase's: K13 at W = 1,024 staged rows (768 dirty) of a 16,384-row
column on a VirtualMesh of D = 1 and 8 shards; K15 at a process's L = 2
shards of 4,096 rows, w = 8 (six dirty rows a shard), the shards views
of one block.  For each it prints, as one JSON line a tree, CUDA-event
means of 1,000 calls after 20 warm-up calls, in ms:

- ``wrapper_ms``: the per-column entry point (`patch_rows_sharded_cuda`,
  `patch_rows_hostlocal_cuda`), which checks and binds on every call;
- where the tree has it (`ops.batch.RowPatch`), ``launch_ms``: the launch
  a delta flush makes, bound once, unchecked, and ``call_ms``: the bound
  patch's checked call on staging tensors;
- ``library_ms``: `index_copy_` of the same rows, into each shard (D
  calls) for K13, into the shards' block (one call) for K15.

The card's name and power limit come first, as nvidia-smi gives them.
Exits 1 without a card, or if any tree's run fails."""
import json
import os
import subprocess
import sys

C = 16_384  # chip_smoke.py's C_CHECK
K13_WIDTH = 1024
K15_SHAPE = (2, 8, 4096)  # L shards, w, shard rows: chip_smoke.py's K15_TIMING
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


class _RankView:
    """A VirtualMesh seen as one process holding the shards `local`."""

    def __init__(self, mesh, local) -> None:
        self.n_shards, self.device = mesh.n_shards, mesh.device
        self.local_shards = tuple(local)


def measure(tree: str) -> dict:
    """The timings of `tree`'s K13 and K15, in this process."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    from nomad_tpu_torch.ops import _cuda
    from nomad_tpu_torch.ops import batch as tbatch
    from nomad_tpu_torch.parallel.mesh import Sharded, VirtualMesh

    if not tbatch.__file__.startswith(tree + os.sep):
        raise RuntimeError(f"imported {tbatch.__file__}, not {tree}'s port")
    cuda = torch.device("cuda", 0)
    _cuda.load([n for n in _cuda.SOURCES if n.startswith("patch_rows_")])
    bound = getattr(tbatch, "RowPatch", None)
    out = {"tree": tree}

    rng = np.random.default_rng(7013)
    col = torch.from_numpy(rng.uniform(0.0, 1e4, C)).to(cuda)
    idx = np.full(K13_WIDTH, C, np.int32)
    n = K13_WIDTH - K13_WIDTH // 4
    idx[:n] = np.sort(rng.choice(C, n, replace=False))
    idx_t = torch.from_numpy(idx).to(cuda)
    vals = torch.from_numpy(rng.uniform(0.0, 1e4, K13_WIDTH)).to(cuda)
    for d in (1, 8):
        mesh = VirtualMesh(d, cuda)
        sh = mesh.shard(col)
        size = C // d
        own = []
        for s, t in enumerate(sh.shards):
            mine = (idx[:n] >= s * size) & (idx[:n] < (s + 1) * size)
            own.append((t, torch.from_numpy(idx[:n][mine] - s * size).long()
                        .to(cuda), vals[:n][torch.from_numpy(mine).to(cuda)]))

        def library():
            for t, i, v in own:
                t.index_copy_(0, i, v)

        row = {"wrapper_ms": _time_ms(lambda: tbatch.patch_rows_sharded_cuda(
            mesh, sh, idx_t, vals))}
        if bound is not None:
            vals1 = vals.unsqueeze(0)
            patch = bound(mesh, (sh,))
            ptrs = (idx_t.data_ptr(), vals1.data_ptr(), K13_WIDTH)
            row["launch_ms"] = _time_ms(lambda: patch.launch(*ptrs))
            row["call_ms"] = _time_ms(lambda: patch(idx_t, vals1))
        row["library_ms"] = _time_ms(library)
        out[f"k13_d{d}"] = row

    L, w, size = K15_SHAPE
    rng = np.random.default_rng(7015)
    block = torch.from_numpy(rng.uniform(0.0, 1e4, L * size)).to(cuda)
    col15 = Sharded(tuple(block.narrow(0, l * size, size) for l in range(L)))
    n = w - w // 4
    stack = np.full((L, w), size, np.int32)
    for l in range(L):
        stack[l, :n] = np.sort(rng.choice(size, n, replace=False))
    svals = rng.uniform(0.0, 1e4, (L, w))
    stack_t = torch.from_numpy(stack).to(cuda)
    svals_t = torch.from_numpy(svals).to(cuda)
    view = _RankView(VirtualMesh(2 * L, cuda), range(L))
    flat_idx = torch.from_numpy(np.concatenate(
        [stack[l, :n].astype(np.int64) + l * size for l in range(L)])).to(cuda)
    flat_vals = torch.from_numpy(np.concatenate(
        [svals[l, :n] for l in range(L)])).to(cuda)
    row = {"wrapper_ms": _time_ms(lambda: tbatch.patch_rows_hostlocal_cuda(
        view, col15, stack_t, svals_t))}
    if bound is not None:
        svals1 = svals_t.unsqueeze(0)
        patch = bound(view, (col15,), hostlocal=True)
        ptrs = (stack_t.data_ptr(), svals1.data_ptr(), w)
        row["launch_ms"] = _time_ms(lambda: patch.launch(*ptrs))
        row["call_ms"] = _time_ms(lambda: patch(stack_t, svals1))
    row["library_ms"] = _time_ms(
        lambda: block.index_copy_(0, flat_idx, flat_vals))
    out["k15"] = row
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
