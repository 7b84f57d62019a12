"""The rank side of the gloo checks of `test_torch_mesh.py`,
`test_torch_storm_sharded.py` and `test_torch_mesh_evals.py`: one process
of a `torch.distributed` gloo world runs the port's sharded programs (the
twins) on a `DistMesh` from `make_mesh` and saves what it got: the
chained planner on `make_mesh(eval_axis=1)` with the axes the default
`make_mesh()` resolves, the sharded storm solve, and the select and the
batched planner on an (evals, nodes) mesh.
Imports only torch, numpy and the port, so the rank also shows that the
port's mesh path loads neither `jax` nor `nomad_tpu`."""
import sys

C, N_CAND, E, P = 128, 120, 6, 5


def chain_results(mesh, scenario: str, seed: int = 41):
    """Rows, pulls and the whole usage carry of one case, cut into two
    chunks with the carry threaded."""
    import torch

    from nomad_tpu_torch.ops.cases import sharded_chain_case
    from nomad_tpu_torch.parallel.mesh import sharded_chained_plan
    from nomad_tpu_torch.state.convert import sharded_case_args

    case = sharded_chain_case(seed, C, N_CAND, scenario, E, P)
    args = sharded_case_args(case)
    run = sharded_chained_plan(mesh, P, with_spread=case["spread"] is not None,
                               spread_even=case["spread_even"],
                               return_carry=True)
    rows, pulls, carry = [], [], args[3:6]
    half = E // 2
    for lo, hi in ((0, half), (half, E)):
        part = [a[lo:hi] if isinstance(a, torch.Tensor) else
                type(a)(*[None if f is None else f[lo:hi] for f in a])
                for a in args[6:]]
        r, p, carry = run(*args[:3], *carry, *part)
        rows.append(r)
        pulls.append(p)
    return (torch.cat(rows), torch.cat(pulls),
            tuple(mesh.unshard(x) for x in carry))


def collectives(mesh, shard: int):
    """Each collective of the mesh on per-shard records."""
    import torch

    x = torch.tensor([shard * 3 - 4, 10 - shard], dtype=torch.int32)
    f = torch.tensor([0.25 * shard, -1.5 * shard], dtype=torch.float64)
    v = torch.arange(4, dtype=torch.float64) + 4 * shard
    return {
        "gather": mesh.gather([x]), "pmax": mesh.pmax([f]),
        "pmin": mesh.pmin([x]), "psum": mesh.psum([f]),
        "all_gather": mesh.all_gather([v]),
    }


def rank_main(rank: int, world: int, init_file: str, out: str,
              scenarios) -> None:
    import torch
    import torch.distributed as dist

    from nomad_tpu_torch.parallel.mesh import make_mesh, mesh_axes

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        # the JAX default axes: (2, world / 2) from 4 ranks; and every
        # rank as an eval row of one node shard
        res = {"axes": mesh_axes(world)}
        default = make_mesh(device="cpu")
        res["default_mesh"] = (default.n_evals, default.n_shards)
        rows = make_mesh(world, eval_axis=world, device="cpu")
        res["eval_mesh"] = (rows.n_evals, rows.n_shards, rows.local_evals,
                            rows.local_shards)
        mesh = make_mesh(eval_axis=1, device="cpu")
        res.update({s: chain_results(mesh, s) for s in scenarios})
        res["collectives"] = collectives(mesh, rank)
        try:  # more shards than ranks: no rank holds two
            make_mesh(world + 1, eval_axis=1, device="cpu")
            res["too_many_shards"] = "built"
        except ValueError as exc:
            res["too_many_shards"] = str(exc)
        res["loaded"] = sorted(
            m for m in sys.modules
            if m in ("jax", "jaxlib", "nomad_tpu")
            or m.startswith(("jax.", "nomad_tpu.")))
        torch.save(res, f"{out}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


STORM_CASES = (("dogpile", False), ("penalty_affinity_collisions", True),
               ("weighted", False))
STORM_E, STORM_A, STORM_C = 8, 48, 128


def storm_results(mesh):
    """The six outputs of the sharded storm solve's twin on each of
    STORM_CASES ((scenario, spread_fit); "weighted" is the weighted
    policy case), inputs made from a seed."""
    from nomad_tpu_torch.ops.cases import policy_storm_case, storm_case
    from nomad_tpu_torch.ops.solve import storm_assignment_sharded
    from nomad_tpu_torch.state.convert import storm_columns, storm_inputs

    out = {}
    for scenario, spread_fit in STORM_CASES:
        weighted = scenario == "weighted"
        make = policy_storm_case if weighted else storm_case
        cols, inp, max_rounds = make(61, STORM_E, STORM_A, STORM_C, scenario)
        run = storm_assignment_sharded(mesh, spread_fit, max_rounds, weighted)
        out[(scenario, spread_fit)] = tuple(
            run(storm_inputs(inp, "cpu"), storm_columns(cols, "cpu")))
    return out


def storm_rank_main(rank: int, world: int, init_file: str, out: str) -> None:
    import torch
    import torch.distributed as dist

    from nomad_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        res = storm_results(make_mesh(eval_axis=1, device="cpu"))
        res["loaded"] = sorted(
            m for m in sys.modules
            if m in ("jax", "jaxlib", "nomad_tpu")
            or m.startswith(("jax.", "nomad_tpu.")))
        torch.save(res, f"{out}/storm{rank}.pt")
    finally:
        dist.destroy_process_group()


EVAL_C, EVAL_E, EVAL_P = 64, 4, 3


def eval_mesh_results(mesh) -> dict:
    """The node-sharded select and the (evals, nodes)-sharded batched
    planner on `mesh`, over the entry module's example inputs at C =
    EVAL_C (three seeds of the select, one batch of EVAL_E evals)."""
    from nomad_tpu_torch.entry import _example_batch, _example_inputs
    from nomad_tpu_torch.parallel.mesh import (
        sharded_batch_plan,
        sharded_score_and_select,
    )

    n_active = EVAL_C - 8
    select = sharded_score_and_select(mesh)
    out = {f"select{seed}": tuple(select(_example_inputs(EVAL_C, n_active, seed)))
           for seed in range(3)}
    cols, batch = _example_batch(EVAL_C, n_active, EVAL_E, EVAL_P)
    out["rows"] = sharded_batch_plan(mesh, n_active, EVAL_P)(*cols, batch)
    return out


def eval_rank_main(rank: int, world: int, init_file: str, out: str) -> None:
    import torch
    import torch.distributed as dist

    from nomad_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        mesh = make_mesh(device="cpu")  # the JAX default axes: 2 x world / 2
        res = eval_mesh_results(mesh)
        res["mesh"] = (mesh.n_evals, mesh.n_shards, mesh.local_evals,
                       mesh.local_shards)
        res["loaded"] = sorted(
            m for m in sys.modules
            if m in ("jax", "jaxlib", "nomad_tpu")
            or m.startswith(("jax.", "nomad_tpu.")))
        torch.save(res, f"{out}/eval{rank}.pt")
    finally:
        dist.destroy_process_group()


# -- several shards a rank: 2 ranks x 2 shards ---------------------------------

HOSTLOCAL_C = 64
HOSTLOCAL_DIRTY = ([0], [3, 8, 9, 17, 40, 63], list(range(24, 48)), "random20")


def hostlocal_dirty_sets(seed: int = 13) -> list:
    """The dirty sets of the JAX package's hostlocal test
    (`tests/test_dist_mesh.py`), the last one drawn from `seed`, each
    with its new values: [(idx sorted i32, values f64[C])]."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for dirty in HOSTLOCAL_DIRTY:
        if dirty == "random20":
            dirty = rng.choice(HOSTLOCAL_C, 20, replace=False).tolist()
        out.append((np.asarray(sorted(dirty), np.int32),
                    rng.random(HOSTLOCAL_C)))
    return out


def hostlocal_results(mesh, col_host) -> list:
    """`patch_rows_hostlocal` (the twin on the CPU) of every dirty set
    into `col_host` placed on `mesh`, this process's staging rows only;
    each result whole ([C], unsharded over the mesh)."""
    import numpy as np
    import torch

    from nomad_tpu_torch.ops.batch import hostlocal_staging, patch_rows_hostlocal
    from nomad_tpu_torch.parallel.mesh import mesh_put

    out = []
    local = list(mesh.local_shards)
    for idx, src in hostlocal_dirty_sets():
        stack, per_dev, w = hostlocal_staging(mesh, idx, HOSTLOCAL_C)
        vals = np.zeros((len(local), w))
        for i, d in enumerate(local):
            vals[i, :len(per_dev[d])] = src[per_dev[d]]
        col = mesh_put(mesh, col_host)
        patch_rows_hostlocal(mesh, col, torch.from_numpy(stack[local]),
                             torch.from_numpy(vals))
        out.append(mesh.unshard(col))
    return out


def multi_shard_rank_main(rank: int, world: int, init_file: str, out: str,
                          per: int) -> None:
    """A rank of `per` shards: the chained planner's twin over every
    scenario, the sharded storm's twin, the hostlocal flush and the
    collectives on ``make_mesh(eval_axis=1, shards_per_rank=per)``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from nomad_tpu_torch.ops.cases import SHARDED_CHAIN_SCENARIOS
    from nomad_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        mesh = make_mesh(eval_axis=1, device="cpu", shards_per_rank=per)
        res = {"mesh": (mesh.n_evals, mesh.n_shards, mesh.local_shards)}
        res.update({s: chain_results(mesh, s) for s in SHARDED_CHAIN_SCENARIOS})
        res["storm"] = storm_results(mesh)
        col = np.random.default_rng(13).random(HOSTLOCAL_C)
        res["hostlocal"] = hostlocal_results(mesh, col)
        res["gather"] = mesh.gather([torch.tensor([s, 10 * s], dtype=torch.int32)
                                     for s in mesh.local_shards])
        res["bool"] = mesh.gather([torch.tensor([s % 2 == 0, True])
                                   for s in mesh.local_shards])
        res["loaded"] = sorted(
            m for m in sys.modules
            if m in ("jax", "jaxlib", "nomad_tpu")
            or m.startswith(("jax.", "nomad_tpu.")))
        torch.save(res, f"{out}/multi{rank}.pt")
    finally:
        dist.destroy_process_group()
