"""The port's node mesh and K12/K13's twins against the JAX package.

`sharded_chained_plan_twin` (parallel/mesh.py, K12's plain twin) on a
`VirtualMesh` of d shards against `nomad_tpu.parallel.mesh.
sharded_chained_plan` on `make_mesh(d, eval_axis=1)` (the conftest's
8-device virtual CPU mesh), d in {1, 2, 4, 8}, over the four scenarios
of `ops/cases.py sharded_chain_case` at C = 128, the chain cut into two
chunks with the usage carry threaded: rows, pulls and the carry exactly
equal in f64, and rows and pulls equal to the unsharded
`chained_plan_picks_cols` of both packages.  `patch_rows_sharded_twin`
(K13's) against `patch_rows_sharded`.  A `DistMesh` over gloo ranks
(world 2 and 4, spawned with torch.multiprocessing) equals the
`VirtualMesh` bit for bit.  A mesh that cannot be built raises."""
import os
import sys
import time

import numpy as np
import pytest
import torch

from nomad_tpu_torch.ops import batch as tbatch
from nomad_tpu_torch.ops.cases import (
    SHARDED_CHAIN_SCENARIOS,
    SHARDED_PER_EVAL,
    sharded_chain_case,
)
from nomad_tpu_torch.parallel.mesh import (
    NodeMesh,
    VirtualMesh,
    make_mesh,
    mesh_axes,
    sharded_chained_plan,
    sharded_chained_plan_twin,
    stage_launches,
)
from nomad_tpu_torch.state.convert import sharded_chain_args

sys.path.insert(0, os.path.dirname(__file__))
import torch_mesh_ranks  # noqa: E402

C, N_CAND, E, P = 128, 120, 8, 6
COUNTS = (1, 2, 4, 8)
SPAWN_LIMIT_S = 60.0


def _jax_types():
    from nomad_tpu.ops.batch import PreDeltas, SpreadInputs, StepDeltas

    return StepDeltas, PreDeltas, SpreadInputs


def _jax_inputs(case):
    """The JAX runner's host tuples for `case`."""
    StepDeltas, PreDeltas, SpreadInputs = _jax_types()
    per_eval = tuple(case["per_eval"][k] for k in SHARDED_PER_EVAL) + (
        StepDeltas(**case["deltas"]), PreDeltas(**case["pre"]))
    spread = (SpreadInputs(**case["spread"]) if case["spread"] is not None
              else None)
    return case["cols"], per_eval, spread


def _evals(x, lo, hi):
    if isinstance(x, np.ndarray):
        return x[lo:hi]
    return type(x)(*[None if f is None else f[lo:hi] for f in x])


def _run_jax(case, d):
    from nomad_tpu.parallel.mesh import make_mesh as jax_mesh
    from nomad_tpu.parallel.mesh import sharded_chained_plan as jax_plan

    cols, per_eval, spread = _jax_inputs(case)
    run = jax_plan(jax_mesh(d, eval_axis=1), P,
                   with_spread=spread is not None,
                   spread_even=case["spread_even"], return_carry=True)
    carry = cols[3:6]
    rows, pulls = [], []
    for lo, hi in ((0, E // 2), (E // 2, E)):
        extra = (_evals(spread, lo, hi),) if spread is not None else ()
        r, p, carry = run(*cols[:3], *carry,
                          *[_evals(x, lo, hi) for x in per_eval], *extra)
        rows.append(np.asarray(r))
        pulls.append(np.asarray(p))
    return (np.concatenate(rows), np.concatenate(pulls),
            tuple(np.asarray(c) for c in carry))


def _run_port(case, mesh, plan=sharded_chained_plan_twin, dtype=torch.float64):
    cols, per_eval, spread = _jax_inputs(case)
    run = plan(mesh, P, with_spread=spread is not None,
               spread_even=case["spread_even"], return_carry=True)
    carry = None
    rows, pulls = [], []
    for lo, hi in ((0, E // 2), (E // 2, E)):
        args = sharded_chain_args(
            cols, tuple(_evals(x, lo, hi) for x in per_eval),
            _evals(spread, lo, hi) if spread is not None else None,
            dtype=dtype)
        if carry is not None:
            args = args[:3] + carry + args[6:]
        r, p, carry = run(*args)
        rows.append(r.cpu().numpy())
        pulls.append(p.cpu().numpy())
    return (np.concatenate(rows), np.concatenate(pulls),
            tuple(mesh.unshard(c).cpu().numpy() for c in carry))


def _unsharded(case):
    """Rows and pulls of the unsharded chained_plan_picks_cols of both
    packages (the T = 1 layout, per-pick scalars broadcast)."""
    from nomad_tpu.ops.batch import ChainInputs
    from nomad_tpu.ops.batch import chained_plan_picks_cols as jax_cols

    from nomad_tpu_torch.state.convert import (
        chain_inputs_from_numpy,
        pre_deltas_from_numpy,
        spread_inputs_from_numpy,
        step_deltas_from_numpy,
    )

    pe = case["per_eval"]
    tile = lambda x: np.tile(np.asarray(x)[:, None], (1, P))  # noqa: E731
    stacked = dict(
        feasible=pe["feasible"][:, None], perm=pe["perm"],
        ask_cpu=tile(pe["ask_cpu"]), ask_mem=tile(pe["ask_mem"]),
        ask_disk=tile(pe["ask_disk"]),
        desired_count=tile(pe["desired_count"]), limit=tile(pe["limits"]),
        distinct_hosts=pe["distinct_hosts"],
        tg_idx=np.zeros((E, P), np.int32))
    kw = dict(wanted=pe["wanted"], coll0=pe["coll0"][:, None],
              affinity=pe["affinity"][:, None])
    cols, per_eval, spread = _jax_inputs(case)
    jr, jp = jax_cols(*cols, ChainInputs(**stacked), pe["n_candidates"], P,
                      deltas=per_eval[12], pre=per_eval[13], spread=spread,
                      **kw)
    sp = (spread_inputs_from_numpy(case["spread"], "cpu")
          if case["spread"] is not None else None)
    if sp is not None and not case["spread_even"]:
        sp = sp._replace(even=None)
    tr, tp = tbatch.chained_plan_picks_cols(
        *[torch.from_numpy(np.asarray(c)) for c in cols],
        chain_inputs_from_numpy(stacked, "cpu"), pe["n_candidates"], P,
        deltas=step_deltas_from_numpy(case["deltas"], "cpu"),
        pre=pre_deltas_from_numpy(case["pre"], "cpu"), spread=sp,
        wanted=pe["wanted"], coll0=pe["coll0"][:, None],
        affinity=pe["affinity"][:, None])
    return np.asarray(jr), np.asarray(jp), tr.numpy(), tp.numpy()


@pytest.mark.parametrize("d", COUNTS)
@pytest.mark.parametrize("scenario", SHARDED_CHAIN_SCENARIOS)
def test_twin_matches_jax_sharded_chain(scenario, d):
    case = sharded_chain_case(1000 + d, C, N_CAND, scenario, E, P)
    j_rows, j_pulls, j_carry = _run_jax(case, d)
    rows, pulls, carry = _run_port(case, VirtualMesh(d, "cpu"))
    assert np.array_equal(rows, j_rows)
    assert np.array_equal(pulls, j_pulls)
    for a, b in zip(carry, j_carry):
        assert np.array_equal(a.view(np.int64), b.view(np.int64))
    # the unsharded programs decide the same rows and pulls
    ur, up, tr, tp = _unsharded(case)
    assert np.array_equal(rows, ur) and np.array_equal(pulls, up)
    assert np.array_equal(rows, tr) and np.array_equal(pulls, tp)
    assert (rows >= 0).any()


@pytest.mark.parametrize("scenario", ("plain", "spread_even"))
def test_spread_fit_matches_jax(scenario):
    """spread_fit (worst-fit) through both packages' sharded chains."""
    from nomad_tpu.parallel.mesh import make_mesh as jax_mesh
    from nomad_tpu.parallel.mesh import sharded_chained_plan as jax_plan

    case = sharded_chain_case(2024, C, N_CAND, scenario, E, P)
    cols, per_eval, spread = _jax_inputs(case)
    extra = (spread,) if spread is not None else ()
    kw = dict(spread_fit=True, with_spread=spread is not None,
              spread_even=case["spread_even"], return_carry=True)
    jr, jp, jc = jax_plan(jax_mesh(4, eval_axis=1), P, **kw)(
        *cols, *per_eval, *extra)
    mesh = VirtualMesh(4, "cpu")
    r, p, c = sharded_chained_plan_twin(mesh, P, **kw)(
        *sharded_chain_args(cols, per_eval, spread))
    assert np.array_equal(r.numpy(), np.asarray(jr))
    assert np.array_equal(p.numpy(), np.asarray(jp))
    for a, b in zip(c, jc):
        assert np.array_equal(mesh.unshard(a).numpy().view(np.int64),
                              np.asarray(b).view(np.int64))


def test_failed_kernel_launch_raises_device_fault(monkeypatch):
    """No fallback: a K12 or K13 launch that fails raises DeviceFault
    (here the CUDA entry points are driven on a CPU mesh, which they
    refuse, and a bind failure is injected)."""
    from nomad_tpu_torch.device import DeviceFault
    from nomad_tpu_torch.ops import _cuda
    from nomad_tpu_torch.parallel import mesh as tmesh

    case = sharded_chain_case(4, C, N_CAND, "plain", 2, 2)
    cols, per_eval, _sp = _jax_inputs(case)
    cpu_mesh = VirtualMesh(2, "cpu")
    c = tmesh.prepare_sharded_chain(cpu_mesh, 2,
                                    sharded_chain_args(cols, per_eval))
    with pytest.raises(ValueError):
        tmesh.sharded_chained_plan_cuda(c)

    class Card:
        type = "cuda"

    def broken(*_a, **_k):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(cpu_mesh, "device", Card())
    monkeypatch.setattr(_cuda, "ShardedChainStages", broken)
    with pytest.raises(DeviceFault):
        tmesh.sharded_chained_plan_cuda(c)
    monkeypatch.setattr(_cuda, "RowPatchLaunch", broken)
    sh = VirtualMesh(2, "cpu").shard(torch.zeros(C, dtype=torch.float64))
    with pytest.raises(DeviceFault):
        tbatch.patch_rows_sharded_cuda(
            cpu_mesh, sh, torch.tensor([1], dtype=torch.int32),
            torch.ones(1, dtype=torch.float64))
    with pytest.raises(DeviceFault):
        tbatch.RowPatch(cpu_mesh, (sh, sh, sh))


@pytest.mark.parametrize("scenario", SHARDED_CHAIN_SCENARIOS)
def test_dispatch_runs_the_twin_on_a_cpu_mesh(scenario):
    """`sharded_chained_plan` on a CPU mesh is the twin, f32 included,
    and no K12 launch is counted."""
    case = sharded_chain_case(77, C, N_CAND, scenario, E, P)
    mesh = VirtualMesh(4, "cpu")
    before = sharded_chained_plan.__globals__[
        "sharded_chained_plan_cuda"].launches
    for dtype in (torch.float64, torch.float32):
        a = _run_port(case, mesh, sharded_chained_plan, dtype)
        b = _run_port(case, mesh, sharded_chained_plan_twin, dtype)
        for x, y in zip(a[:2], b[:2]):
            assert np.array_equal(x, y)
    assert sharded_chained_plan.__globals__[
        "sharded_chained_plan_cuda"].launches == before


@pytest.mark.parametrize("d", COUNTS)
@pytest.mark.parametrize("width", (8, 64, 128))
def test_patch_rows_sharded_twin_matches_jax(d, width):
    from nomad_tpu.ops.batch import patch_rows_sharded as jax_patch
    from nomad_tpu.parallel.mesh import make_mesh as jax_mesh

    rng = np.random.default_rng(width + d)
    col = rng.uniform(0.0, 1e4, C)
    n = max(1, width - width // 4)
    idx = np.full(width, C, np.int32)  # padding: dropped
    idx[:n] = np.sort(rng.choice(C, n, replace=False))
    vals = rng.uniform(0.0, 1e4, width)
    want = np.asarray(jax_patch(jax_mesh(d, eval_axis=1))(col, idx, vals))
    mesh = VirtualMesh(d, "cpu")
    sh = mesh.shard(col)
    out = tbatch.patch_rows_sharded(mesh, sh, torch.from_numpy(idx),
                                    torch.from_numpy(vals))
    assert out is sh
    got = mesh.unshard(sh).numpy()
    assert np.array_equal(got.view(np.int64), want.view(np.int64))
    # the unsharded K4 twin on the whole column agrees
    whole = tbatch.patch_rows_twin(torch.from_numpy(col.copy()),
                                   torch.from_numpy(idx),
                                   torch.from_numpy(vals)).numpy()
    assert np.array_equal(got.view(np.int64), whole.view(np.int64))


# -- the mirror's flush: K13 for three columns in one launch ----------------------

STACK_C = 2048  # 1,024 dirty rows fit at every D


def _stacked_case(seed, width, dtype):
    """Three host columns [3, STACK_C] and a replicated staging of W:
    three quarters sorted rows over every shard, two negative rows, the
    rest padding (idx == C); vals [3, W]."""
    rng = np.random.default_rng(seed)
    host = rng.uniform(0.0, 1e4, (3, STACK_C)).astype(dtype)
    n = max(1, width - width // 4)
    idx = np.full(width, STACK_C, np.int32)
    idx[:n] = np.sort(rng.choice(STACK_C, n, replace=False))
    idx[n] = -1
    if n + 2 < width:
        idx[n + 1] = -STACK_C
    vals = rng.uniform(0.0, 1e4, (3, width)).astype(dtype)
    return host, idx, vals


def _place(mesh, host, layout):
    """One host column as `mesh`'s shards: clones (`mesh.shard`) or views
    of one block (`mesh_put`)."""
    from nomad_tpu_torch.parallel.mesh import mesh_put

    t = torch.from_numpy(host.copy())
    return mesh.shard(t) if layout == "clones" else mesh_put(mesh, t)


def _jax_sharded_cols(d, host, idx, vals):
    """The JAX `patch_rows_sharded` applied column by column on its
    d-device mesh: [3, C]."""
    from nomad_tpu.ops.batch import patch_rows_sharded as jax_patch
    from nomad_tpu.parallel.mesh import make_mesh as jax_mesh

    fn = jax_patch(jax_mesh(d, eval_axis=1))
    return np.stack([np.asarray(fn(h, idx, v)) for h, v in zip(host, vals)])


def _bits64(a):
    a = np.ascontiguousarray(a)
    return a.view(np.int64 if a.dtype == np.float64 else np.int32)


@pytest.mark.parametrize("layout", ("clones", "views"))
@pytest.mark.parametrize("dtype", (np.float64, np.float32))
@pytest.mark.parametrize("width", (8, 1024))
@pytest.mark.parametrize("d", COUNTS)
def test_stacked_sharded_twin_matches_jax_per_column(d, width, dtype, layout):
    """`patch_rows_sharded_cols_twin` (K13's stacked twin) of three
    columns from one replicated staging, padding and negative rows
    dropped, equals the JAX `patch_rows_sharded` column by column, and
    the per-column port calls, bit for bit; a CPU `RowPatch` bound to
    the columns gives the same."""
    host, idx, vals = _stacked_case(1400 + d + width, width, dtype)
    want = _jax_sharded_cols(d, host, idx, vals)
    mesh = VirtualMesh(d, "cpu")
    before = tbatch.patch_rows_sharded_cuda.launches
    for run in ("cols", "patch", "per_column"):
        cols = tuple(_place(mesh, h, layout) for h in host)
        it, vt = torch.from_numpy(idx), torch.from_numpy(vals)
        if run == "cols":
            assert tbatch.patch_rows_sharded_cols_twin(mesh, cols, it,
                                                       vt) == cols
        elif run == "patch":
            tbatch.RowPatch(mesh, cols)(it, vt)
        else:
            for col, v in zip(cols, vt):
                tbatch.patch_rows_sharded(mesh, col, it, v)
        got = np.stack([mesh.unshard(c).numpy() for c in cols])
        assert np.array_equal(_bits64(got), _bits64(want)), run
    assert tbatch.patch_rows_sharded_cuda.launches == before  # twins only


@pytest.mark.parametrize("layout", ("clones", "views"))
@pytest.mark.parametrize("dtype", (np.float64, np.float32))
@pytest.mark.parametrize("width", (8, 1024))
def test_stacked_sharded_twin_on_a_rank_of_shards_2_and_3(width, dtype,
                                                          layout):
    """A rank holding shards 2 and 3 of 4 takes the replicated staging of
    every shard's rows and stores only its own: its shards equal rows
    [C / 2, C) of the JAX program on four devices."""
    host, idx, vals = _stacked_case(1500 + width, width, dtype)
    want = _jax_sharded_cols(4, host, idx, vals)[:, STACK_C // 2:]
    rank = VirtualMesh(4, "cpu")
    rank.local_shards = (2, 3)
    cols = tuple(_place(rank, h, layout) for h in host)
    tbatch.RowPatch(rank, cols)(torch.from_numpy(idx), torch.from_numpy(vals))
    got = np.stack([torch.cat(c.shards).numpy() for c in cols])
    assert np.array_equal(_bits64(got), _bits64(want))


def test_stacked_patch_checks_its_staging():
    mesh = VirtualMesh(2, "cpu")
    cols = tuple(mesh.shard(torch.zeros(16, dtype=torch.float64))
                 for _ in range(3))
    idx = torch.full((8,), 16, dtype=torch.int32)
    vals = torch.zeros((3, 8), dtype=torch.float64)
    with pytest.raises(ValueError, match="one staging row a column"):
        tbatch.RowPatch(mesh, cols)(idx, vals[:2])
    with pytest.raises(TypeError):
        tbatch.RowPatch(mesh, cols)(idx.long(), vals)
    with pytest.raises(TypeError):
        tbatch.patch_rows_sharded_cols_twin(mesh, cols, idx, vals.float())
    with pytest.raises(TypeError):
        tbatch.RowPatch(mesh, cols[:2] + (mesh.shard(torch.zeros(16)),))
    with pytest.raises(ValueError, match="another mesh"):
        tbatch.RowPatch(mesh, (VirtualMesh(4, "cpu").shard(torch.zeros(16)),))
    with pytest.raises(ValueError, match="on the card"):
        tbatch.patch_rows_sharded_cuda(mesh, cols[0], idx, vals[0])


def _mesh_server(mesh):
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.server import Server

    server = Server(num_schedulers=1, seed=3, batch_pipeline=True,
                    heartbeat_ttl=1e9, device="cpu", mesh=mesh)
    for i in range(64):
        node = mock.node(id=f"flush-node-{i}")
        node.node_resources.cpu = 4000 + 1000 * (i % 3)
        server.register_node(node)
    return server


def _used(table):
    return (table.cpu_used, table.mem_used, table.disk_used)


def test_worker_flush_is_one_staging_and_equals_a_fresh_upload():
    """A meshed worker's delta flush on a CPU VirtualMesh(4): one staging
    buffer moved once and one store for all three usage columns (the
    counters), and the mirror equals a fresh upload of the host columns
    bit for bit, the rows it re-stored first spoiled on the mesh."""
    from nomad_tpu_torch import mock

    mesh = VirtualMesh(4, "cpu")
    server = _mesh_server(mesh)
    server.start()
    try:
        worker = server.workers[0]
        table = server.store.node_table
        worker._device_columns(table, sharded=True)
        cold = worker._usage_cache_sharded["gen"]
        for i in range(6):
            job = mock.job(id=f"flush-{i}")
            job.task_groups[0].count = 3
            server.register_job(job)
        assert server.drain_to_idle(60)
        cache = worker._usage_cache_sharded
        # replay the delta since the cold sync over spoiled rows
        _gen, dirty = server.store.usage_delta_since(cold)
        assert 0 < len(dirty) <= 64
        size = table.capacity // 4
        for col in cache["cols"][3:]:
            for r in dirty:
                col.shards[r // size][r % size] = -1.0
        cache["gen"] = cold
        flushes, copies = tbatch.RowPatch.flushes, tbatch.RowPatch.copies
        width = tbatch.pow2_bucket(len(dirty), floor=8)
        cols = worker._device_columns(table, sharded=True)
        assert tbatch.RowPatch.flushes - flushes == 1
        assert tbatch.RowPatch.copies - copies == 1
        assert server.metrics.get_gauge("mesh.bytes_per_flush") == (
            width * 4 + 3 * width * 8)
        for col, host in zip(cols[3:], _used(table)):
            assert np.array_equal(_bits64(mesh.unshard(col).numpy()),
                                  _bits64(host))
    finally:
        server.stop()


def test_flush_table_is_rebuilt_after_a_full_resync_and_a_bulk_upload(
        monkeypatch):
    """The mirror's `RowPatch` is bound to the usage tensors of the
    latest full or bulk sync: a new node (a full resync) and a wide
    churn (a bulk upload) each rebind it to the new tensors, and a delta
    keeps it."""
    from nomad_tpu_torch import mock

    server = _mesh_server(VirtualMesh(2, "cpu"))
    try:
        worker = server.workers[0]
        table = server.store.node_table

        def bound():
            cache = worker._usage_cache_sharded
            patch = cache["patch"]
            assert all(a is b for a, b in zip(patch.cols, cache["cols"][3:]))
            assert len(patch.cols) == 3 and not patch.hostlocal
            return patch

        worker._device_columns(table, sharded=True)
        first = bound()
        worker._device_columns(table, sharded=True)  # nothing dirty
        assert bound() is first
        server.register_node(mock.node(id="flush-node-new"))
        worker._device_columns(table, sharded=True)  # a full resync
        full = bound()
        assert full is not first
        gen = worker._usage_cache_sharded["gen"]
        monkeypatch.setattr(server.store, "usage_delta_since",
                            lambda _g: (gen + 1, list(range(table.capacity))))
        worker._device_columns(table, sharded=True)  # a bulk upload
        bulk = bound()
        assert bulk is not full
        assert bulk.cols[0] is not full.cols[0]
        monkeypatch.setattr(server.store, "usage_delta_since",
                            lambda _g: (gen + 2, [0, 5]))
        worker._device_columns(table, sharded=True)  # a delta
        assert bound() is bulk
    finally:
        server.stop()


def test_virtual_collectives_are_ordered_reductions():
    mesh = VirtualMesh(4, "cpu")
    xs = [torch.tensor([s * 3 - 4, 10 - s], dtype=torch.int32) for s in range(4)]
    assert mesh.gather(xs).tolist() == [x.tolist() for x in xs]
    assert mesh.pmax(xs).tolist() == [5, 10]
    assert mesh.pmin(xs).tolist() == [-4, 7]
    assert mesh.psum(xs).tolist() == [2, 34]
    vs = [torch.arange(3) + 3 * s for s in range(4)]
    assert mesh.all_gather(vs).tolist() == list(range(12))
    col = torch.arange(16, dtype=torch.float64)
    sh = mesh.shard(col)
    assert len(sh.shards) == 4 and sh.shards[1].tolist() == [4.0, 5.0, 6.0, 7.0]
    assert torch.equal(mesh.unshard(sh), col)
    assert mesh.shard(sh) is sh


def test_stage_launch_count():
    # one cooperative launch a chain on a VirtualMesh of any width
    assert stage_launches(VirtualMesh(8, "cpu"), 8, 10) == 1
    assert stage_launches(VirtualMesh(1, "cpu"), 2, 3) == 1
    # staged on a mesh whose exchanges cross processes: per eval begin
    # and a prologue a local shard, per pick five stages a shard and one
    # advance (a bare NodeMesh stands for a DistMesh rank's shards)
    staged = NodeMesh()
    staged.local_shards = tuple(range(8))
    assert stage_launches(staged, 8, 10) == 8 * (1 + 8 + 10 * 41)
    staged.local_shards = (0,)
    assert stage_launches(staged, 2, 3) == 2 * (1 + 1 + 3 * 6)


def test_mesh_that_cannot_be_built_raises(tmp_path):
    with pytest.raises(ValueError):
        VirtualMesh(3, "cpu").shard_size(128)  # C % D != 0
    with pytest.raises(ValueError):
        VirtualMesh(0, "cpu")
    with pytest.raises(ValueError):
        VirtualMesh(2, "cpu", n_evals=0)
    with pytest.raises(ValueError):
        VirtualMesh(2, "cpu", n_evals=2).eval_rows(5)  # E % evals != 0
    case = sharded_chain_case(3, 96, 90, "plain", 2, 2)
    cols, per_eval, _sp = _jax_inputs(case)
    run = sharded_chained_plan_twin(VirtualMesh(5, "cpu"), 2)
    with pytest.raises(ValueError):
        run(*sharded_chain_args(cols, per_eval))
    if not torch.distributed.is_initialized():
        with pytest.raises(RuntimeError):
            make_mesh(2)  # no torch.distributed group


@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_axes_are_the_jax_defaults(n):
    """`mesh_axes` resolves the (evals, nodes) axes of the JAX
    `make_mesh(n)` on the conftest's 8 virtual devices; an explicit
    eval axis of 1 is the node axis alone."""
    from nomad_tpu.parallel.mesh import make_mesh as jax_mesh

    assert mesh_axes(n) == tuple(jax_mesh(n).devices.shape)
    assert mesh_axes(n, 1) == (1, n)


def _spawn(world, target, args_of, timeout=SPAWN_LIMIT_S):
    """Start `world` spawned processes, join each within what is left of
    `timeout`; kill every one still alive on expiry and fail."""
    import torch.multiprocessing as tmp

    ctx = tmp.get_context("spawn")
    procs = [ctx.Process(target=target, args=args_of(r)) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        alive = [p for p in procs if p.is_alive()]
        assert not alive, f"{len(alive)} rank(s) outlived the {timeout} s limit"
        assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)


@pytest.mark.parametrize("world", (2, 4))
def test_virtual_mesh_equals_gloo_ranks(world, tmp_path):
    scenarios = SHARDED_CHAIN_SCENARIOS
    init = tmp_path / "init"
    _spawn(world, torch_mesh_ranks.rank_main,
           lambda r: (r, world, str(init), str(tmp_path), scenarios))
    mesh = VirtualMesh(world, "cpu")
    want = {s: torch_mesh_ranks.chain_results(mesh, s) for s in scenarios}
    coll = [torch_mesh_ranks.collectives(VirtualMesh(1, "cpu"), s)
            for s in range(world)]
    from nomad_tpu.parallel.mesh import make_mesh as jax_mesh

    jax_axes = tuple(jax_mesh(world).devices.shape)
    for rank in range(world):
        got = torch.load(tmp_path / f"rank{rank}.pt")
        assert got["loaded"] == []
        # make_mesh(world) builds the JAX default axes; with an eval
        # axis of `world`, rank r is eval row r of one node shard
        assert tuple(got["axes"]) == jax_axes
        assert got["default_mesh"] == jax_axes
        assert got["eval_mesh"] == (world, 1, (rank,), (0,))
        assert "shards asked of a group" in got["too_many_shards"]
        for s in scenarios:
            for a, b in zip(got[s][:2], want[s][:2]):
                assert torch.equal(a, b)
            for a, b in zip(got[s][2], want[s][2]):
                assert torch.equal(a.view(torch.int64), b.view(torch.int64))
        c = got["collectives"]
        assert c["gather"].tolist() == [x["gather"][0].tolist() for x in coll]
        assert c["pmax"].tolist() == torch.stack(
            [x["psum"] for x in coll]).amax(0).tolist()
        assert c["pmin"].tolist() == torch.stack(
            [x["pmin"] for x in coll]).amin(0).tolist()
        assert c["psum"].tolist() == sum(x["psum"] for x in coll).tolist()
        assert c["all_gather"].tolist() == list(range(4 * world))


def test_device_none_is_the_card():
    """`VirtualMesh(d)` and the multichip sweep default to the card and
    raise without one; nothing falls back to the CPU."""
    from nomad_tpu_torch.device import NoDeviceError
    from nomad_tpu_torch.parallel.multichip import multichip_sweep

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(NoDeviceError):
        VirtualMesh(2)
    with pytest.raises(NoDeviceError):
        multichip_sweep()
