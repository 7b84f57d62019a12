"""The node-sharded storm solve (`ops/solve.py storm_assignment_sharded`,
kernel K14's plain twin) against the JAX package.

`storm_assignment_sharded_twin` on a `VirtualMesh` of d shards against
the JAX `storm_assignment_sharded` on `make_mesh(d, eval_axis=1)` (the
conftest's 8-device virtual CPU mesh), d in {1, 2, 4, 8}: all six
outputs exactly equal (f64 bits, the sign of a zero score included),
on `tests/test_dist_mesh.py`'s shapes (a dogpile, random masks, a one-row
storm, infeasible rows, padding rows with a round cap), spread_fit on
and off, and a weighted storm.  The port's unsharded K5 twin decides the
same.  A `DistMesh` over 2 and 4 gloo ranks equals the `VirtualMesh`."""
import os
import sys

import numpy as np
import pytest
import torch

from nomad_tpu_torch.ops import solve as tsolve
from nomad_tpu_torch.ops.cases import policy_storm_case
from nomad_tpu_torch.parallel.mesh import Sharded, VirtualMesh
from nomad_tpu_torch.sched.storm import stage_for_mesh
from nomad_tpu_torch.state.convert import storm_columns, storm_inputs

sys.path.insert(0, os.path.dirname(__file__))
import torch_mesh_ranks  # noqa: E402
from test_torch_mesh import _spawn  # noqa: E402

COUNTS = (1, 2, 4, 8)
COLS = ("cpu_total", "mem_total", "disk_total", "cpu_used", "mem_used",
        "disk_used")


def storm_problem(E, A, C, ask=(100.0, 100.0, 100.0), limit=2, seed=0,
                  shared_perm=False, feas_p=0.15):
    """`tests/test_dist_mesh.py _storm_problem`'s inputs, as numpy: the
    StormInputs fields and the six node columns."""
    rng = np.random.default_rng(seed)
    if shared_perm:
        perm = np.tile(rng.permutation(C).astype(np.int32), (E, 1))
    else:
        perm = np.stack([rng.permutation(C).astype(np.int32)
                         for _ in range(E)])
    inp = dict(
        feasible=rng.random((E, C)) > feas_p,
        affinity=np.where(rng.random((E, C)) > 0.8, rng.random((E, C)), 0.0),
        collisions=(rng.random((E, C)) > 0.9).astype(np.int32),
        perm=perm,
        limit=np.full(E, limit, np.int32),
        n_cand=np.full(E, C, np.int32),
        eval_of=(np.arange(A) % E).astype(np.int32),
        penalty=rng.random((A, C)) > 0.95,
        ask=np.tile(np.asarray(ask, np.float64), (A, 1)),
        desired=np.ones(A, np.int32),
        real=np.ones(A, bool),
        pre_cpu=np.zeros(C), pre_mem=np.zeros(C), pre_disk=np.zeros(C),
    )
    cols = dict(zip(COLS, (
        np.full(C, 4000.0), np.full(C, 8192.0), np.full(C, 100000.0),
        rng.integers(0, 2000, C).astype(np.float64),
        rng.integers(0, 4096, C).astype(np.float64), np.zeros(C))))
    return inp, cols


SHAPES = {
    # identical-ask dog-pile on one shared walk order
    "dogpile": ((16, 64, 256), dict(ask=(1000.0, 100.0, 100.0),
                                    shared_perm=True)),
    # mixed random feasibility / affinities / penalties
    "mixed": ((8, 32, 64), dict(seed=3)),
    "limit5": ((4, 8, 128), dict(seed=9, limit=5)),
    # the degenerate one-row storm
    "one_row": ((1, 1, 16), dict(seed=7, limit=3)),
    # infeasible-heavy: NO_NODE rows
    "infeasible": ((16, 128, 64), dict(ask=(3000.0, 4000.0, 50000.0),
                                       seed=5)),
}


def run_jax(inp, cols, d, spread_fit, max_rounds, weighted=False):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from nomad_tpu.ops.solve import StormInputs, storm_assignment_sharded
    from nomad_tpu.parallel.mesh import make_mesh
    from nomad_tpu.sched.storm import stage_for_mesh as jax_stage

    mesh = make_mesh(d, eval_axis=1)
    fn = storm_assignment_sharded(mesh, spread_fit=spread_fit,
                                  max_rounds=max_rounds, weighted=weighted)
    out = fn(jax_stage(StormInputs(**inp), mesh),
             tuple(jax.device_put(cols[k], NamedSharding(mesh, P("nodes")))
                   for k in COLS))
    return [np.asarray(x) for x in out]


def run_port(inp, cols, mesh, spread_fit, max_rounds, weighted=False,
             plan=tsolve.storm_assignment_sharded_twin, dtype=torch.float64):
    run = plan(mesh, spread_fit, max_rounds, weighted)
    return run(stage_for_mesh(storm_inputs(inp, "cpu", dtype), mesh),
               tuple(mesh.shard(c) for c in storm_columns(cols, "cpu", dtype)))


def assert_bits(got, want):
    for name, g, w in zip(tsolve.StormOut._fields, got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        if name == "score":
            assert g.dtype == w.dtype, name
            view = np.int64 if g.dtype == np.float64 else np.int32
            np.testing.assert_array_equal(g.view(view), w.view(view),
                                          err_msg=name)
        else:
            np.testing.assert_array_equal(g, w.astype(np.int32), err_msg=name)


def assert_same_as_unsharded(got, inp, cols, spread_fit, max_rounds):
    """The unsharded K5 twin decides the same (a zero score's sign aside:
    the sharded read adds +0.0 from the other shards)."""
    want = tsolve.storm_assignment_twin(storm_inputs(inp, "cpu"),
                                        storm_columns(cols, "cpu"),
                                        spread_fit, max_rounds)
    for name, g, w in zip(tsolve.StormOut._fields, got, want):
        assert torch.equal(g, w), name


@pytest.mark.parametrize("d", COUNTS)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_twin_matches_jax_sharded_storm(shape, d):
    (E, A, C), kw = SHAPES[shape]
    inp, cols = storm_problem(E, A, C, **kw)
    want = run_jax(inp, cols, d, False, A)
    got = run_port(inp, cols, VirtualMesh(d, "cpu"), False, A)
    assert_bits(got, want)
    assert_same_as_unsharded(got, inp, cols, False, A)
    if shape == "infeasible":
        assert (want[0] == -1).any()
    if shape == "dogpile":
        assert int(want[5]) >= 3


@pytest.mark.parametrize("d", (2, 8))
@pytest.mark.parametrize("shape", ("dogpile", "mixed"))
def test_spread_fit_matches_jax(shape, d):
    (E, A, C), kw = SHAPES[shape]
    inp, cols = storm_problem(E, A, C, **kw)
    want = run_jax(inp, cols, d, True, A)
    got = run_port(inp, cols, VirtualMesh(d, "cpu"), True, A)
    assert_bits(got, want)
    assert_same_as_unsharded(got, inp, cols, True, A)


@pytest.mark.parametrize("d", COUNTS)
def test_padding_rows_and_round_cap_match_jax(d):
    """Padding rows stay NO_NODE and a round-capped solve caps as the
    JAX program does."""
    inp, cols = storm_problem(4, 16, 64, seed=2)
    inp["real"][11:] = False
    want = run_jax(inp, cols, d, False, 2)
    got = run_port(inp, cols, VirtualMesh(d, "cpu"), False, 2)
    assert_bits(got, want)
    assert (want[0][11:] == -1).all() and int(want[5]) <= 2
    assert_same_as_unsharded(got, inp, cols, False, 2)


@pytest.mark.parametrize("d", COUNTS)
def test_weighted_storm_matches_jax(d):
    cols, inp, max_rounds = policy_storm_case(4242, 8, 32, 128, "dogpile")
    want = run_jax(inp, cols, d, False, max_rounds, weighted=True)
    got = run_port(inp, cols, VirtualMesh(d, "cpu"), False, max_rounds,
                   weighted=True)
    assert_bits(got, want)
    assert_same_as_unsharded(got, inp, cols, False, max_rounds)
    assert int(want[5]) >= 2


def test_dispatch_runs_the_twin_on_a_cpu_mesh():
    """`storm_assignment_sharded` on a CPU mesh is the twin, f32
    included, and counts no K14 launch; whole (unplaced) inputs equal
    placed ones; the sharded node columns are read in place."""
    (E, A, C), kw = SHAPES["dogpile"]
    inp, cols = storm_problem(E, A, C, **kw)
    mesh = VirtualMesh(4, "cpu")
    before = tsolve.storm_assignment_sharded_cuda.launches
    for dtype in (torch.float64, torch.float32):
        a = run_port(inp, cols, mesh, False, A, plan=tsolve.storm_assignment_sharded,
                     dtype=dtype)
        b = run_port(inp, cols, mesh, False, A, dtype=dtype)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    whole = tsolve.storm_assignment_sharded(mesh, False, A)(
        storm_inputs(inp, "cpu"), storm_columns(cols, "cpu"))
    for x, y in zip(whole, run_port(inp, cols, mesh, False, A)):
        assert torch.equal(x, y)
    assert tsolve.storm_assignment_sharded_cuda.launches == before
    sharded = tuple(mesh.shard(c) for c in storm_columns(cols, "cpu"))
    st = tsolve.prepare_sharded_storm(
        mesh, stage_for_mesh(storm_inputs(inp, "cpu"), mesh), sharded, False, A)
    for i, sh in enumerate(st.shards):
        for t, col in zip(sh.tot + sh.used, sharded):
            assert t.data_ptr() == col.shards[i].data_ptr()


def test_stage_for_mesh_layout():
    """Node-indexed leaves land as Sharded along their node axis, the
    others whole on the mesh's device; an unweighted storm keeps its
    policy leaves absent."""
    cols, inp, _mr = policy_storm_case(5, 4, 16, 64, "weighted")
    mesh = VirtualMesh(4, "cpu")
    for weighted in (False, True):
        raw = dict(inp) if weighted else {
            k: v for k, v in inp.items() if not k.startswith("policy_")}
        placed = stage_for_mesh(storm_inputs(raw, "cpu"), mesh)
        for name, spec in zip(tsolve.StormInputs._fields,
                              tsolve.storm_in_specs(weighted)):
            leaf = getattr(placed, name)
            if spec is None:
                assert leaf is None, name
            elif spec == tsolve.REPLICATED:
                assert isinstance(leaf, torch.Tensor), name
                assert np.array_equal(leaf.numpy(), np.asarray(raw[name]))
            else:
                axis = 1 if spec == tsolve.SHARD_ROWS else 0
                assert isinstance(leaf, Sharded), name
                whole = torch.cat(leaf.shards, dim=axis).numpy()
                assert np.array_equal(whole, np.asarray(raw[name])), name


def test_mismatched_inputs_raise():
    inp, cols = storm_problem(4, 8, 64, seed=1)
    tin, tcols = storm_inputs(inp, "cpu"), storm_columns(cols, "cpu")
    with pytest.raises(ValueError):  # 64 rows do not split into 3 shards
        tsolve.storm_assignment_sharded(VirtualMesh(3, "cpu"), False, 8)(
            tin, tcols)
    with pytest.raises(ValueError):  # policy rows for an unweighted solve
        cols_w, inp_w, _mr = policy_storm_case(5, 4, 8, 64, "weighted")
        tsolve.storm_assignment_sharded(VirtualMesh(2, "cpu"), False, 8)(
            storm_inputs(inp_w, "cpu"), storm_columns(cols_w, "cpu"))
    with pytest.raises(ValueError):  # a column of another width
        bad = tcols[:5] + (torch.zeros(32, dtype=torch.float64),)
        tsolve.storm_assignment_sharded(VirtualMesh(2, "cpu"), False, 8)(
            tin, bad)


def test_failed_kernel_launch_raises_device_fault(monkeypatch):
    """No fallback: K14 on a CPU mesh refuses, and a failed build or
    launch raises DeviceFault."""
    from nomad_tpu_torch.device import DeviceFault
    from nomad_tpu_torch.ops import _cuda

    inp, cols = storm_problem(4, 8, 64, seed=1)
    mesh = VirtualMesh(2, "cpu")
    st = tsolve.prepare_sharded_storm(mesh, storm_inputs(inp, "cpu"),
                                      storm_columns(cols, "cpu"), False, 8)
    with pytest.raises(ValueError):
        tsolve.storm_assignment_sharded_cuda(st)

    class Card:
        type = "cuda"

    def broken(*_a, **_k):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(mesh, "device", Card())
    monkeypatch.setattr(_cuda, "StormShardedStages", broken)
    with pytest.raises(DeviceFault):
        tsolve.storm_assignment_sharded_cuda(st)


def test_stage_launch_count():
    # a VirtualMesh: a score stage a shard, the walk and one cooperative
    # launch, whatever the rounds
    assert tsolve.storm_stage_launches(VirtualMesh(1, "cpu"), 369) == 3
    assert tsolve.storm_stage_launches(VirtualMesh(8, "cpu"), 10) == 10
    # any other mesh (a DistMesh's local shards): the staged launches
    from types import SimpleNamespace

    for d, rounds, want in ((1, 369, 4 + 369 * 7), (8, 10, 18 + 10 * 42)):
        local = SimpleNamespace(local_shards=list(range(d)))
        assert tsolve.storm_stage_launches(local, rounds) == want


@pytest.mark.parametrize("world", (2, 4))
def test_virtual_mesh_equals_gloo_ranks(world, tmp_path):
    init = tmp_path / "init"
    _spawn(world, torch_mesh_ranks.storm_rank_main,
           lambda r: (r, world, str(init), str(tmp_path)))
    want = torch_mesh_ranks.storm_results(VirtualMesh(world, "cpu"))
    for rank in range(world):
        got = torch.load(tmp_path / f"storm{rank}.pt")
        assert got["loaded"] == []
        for key in torch_mesh_ranks.STORM_CASES:
            for a, b in zip(got[key], want[key]):
                assert a.dtype == b.dtype
                if a.dtype == torch.float64:
                    a, b = a.view(torch.int64), b.view(torch.int64)
                assert torch.equal(a, b), key
