"""The port's (evals, nodes) mesh and its two programs on it against the
JAX package.

`sharded_score_and_select` (K11 a shard, the all-gather, K6; here their
twins) and `sharded_batch_plan` (the node-axis all-gathers, K10 an eval
row; here its twin) on a `VirtualMesh` of (evals, nodes) = (1, 1),
(1, 8) and (2, 4), against `nomad_tpu.parallel.sharded_score_and_select`
and `sharded_batch_plan` on `make_mesh(8)` (the conftest's 8-device
virtual CPU mesh, 2 x 4), on `tests/test_parallel.py`'s seeded recipes
at C = 256, in f64 and f32: every output exactly equal, and equal to
the port's unsharded `score_and_select` and `batch_plan_picks`.  (In f32
the two packages may round one node's 10^x apart, the JAX program taking
the pow in f32 and the port in f64; the outputs compared here are
equal.)  A `ScoreInputs` with policy terms raises on both sides.  The
mesh axes equal the JAX `make_mesh(n)`'s for n = 1-8, and a gloo world
of 4 ranks (a 2 x 2 `DistMesh`) gives what the 2 x 2 `VirtualMesh`
gives."""
import os
import sys

import numpy as np
import pytest
import torch

from nomad_tpu_torch.ops import batch as tbatch
from nomad_tpu_torch.ops import score as tscore
from nomad_tpu_torch.parallel import (
    VirtualMesh,
    make_mesh,
    mesh_axes,
    sharded_batch_plan,
    sharded_score_and_select,
)

sys.path.insert(0, os.path.dirname(__file__))
import torch_mesh_ranks  # noqa: E402
from test_parallel import C, _batch_inputs, _random_inputs  # noqa: E402
from test_torch_mesh import _spawn  # noqa: E402

MESHES = ((1, 1), (1, 8), (2, 4))  # (evals, nodes)
DTYPES = (np.float64, np.float32)
N_ACTIVE = 200
E, P = 4, 3
_JAX = {}


def _jax_mesh():
    from nomad_tpu.parallel import make_mesh as jax_mesh

    if "mesh" not in _JAX:
        _JAX["mesh"] = jax_mesh(8)
    return _JAX["mesh"]


def _jax_select():
    from nomad_tpu.parallel import sharded_score_and_select as jax_select

    if "select" not in _JAX:
        _JAX["select"] = jax_select(_jax_mesh())
    return _JAX["select"]


def _as_dtype(tup, np_dtype, fields):
    return tup._replace(**{f: np.asarray(getattr(tup, f)).astype(np_dtype)
                           for f in fields})


_SELECT_FLOATS = ("cpu_total", "mem_total", "disk_total", "cpu_used",
                  "mem_used", "disk_used", "affinity_score", "spread_boost",
                  "ask_cpu", "ask_mem", "ask_disk")
_BATCH_FLOATS = ("base_cpu_used", "base_mem_used", "base_disk_used",
                 "affinity_score", "ask_cpu", "ask_mem", "ask_disk")


def _bits(x):
    a = np.asarray(x)
    return a.view(np.int64 if a.dtype == np.float64 else np.int32).item()


def _same_select(got, want):
    row, best, n, pulls = (np.asarray(x) for x in got)
    w_row, w_best, w_n, w_pulls = (np.asarray(x) for x in want)
    assert best.dtype == w_best.dtype
    assert (int(row), _bits(best), int(n), int(pulls)) == (
        int(w_row), _bits(w_best), int(w_n), int(w_pulls))


@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_axes_build_the_jax_defaults(n):
    """`make_mesh(n)`'s axes are the JAX default (evals, nodes) axes for
    n = 1-8, and a VirtualMesh of them holds n shards; an explicit eval
    axis of 1 is the node axis alone, and one of n is n rows of one
    shard (`make_mesh(2, eval_axis=2)`: 2 x 1).  Without a process group
    `make_mesh` raises (no fallback); the gloo tests build it."""
    from nomad_tpu.parallel import make_mesh as jax_mesh

    evals, nodes = mesh_axes(n)
    assert (evals, nodes) == tuple(jax_mesh(n).devices.shape)
    mesh = VirtualMesh(nodes, "cpu", n_evals=evals)
    assert (mesh.n_evals, mesh.n_shards) == (evals, nodes)
    assert mesh.local_evals == tuple(range(evals))
    assert mesh_axes(n, 1) == (1, n)
    assert mesh_axes(n, n) == (n, 1) == tuple(
        jax_mesh(n, eval_axis=n).devices.shape)
    if not torch.distributed.is_initialized():
        with pytest.raises(RuntimeError):
            make_mesh(n)


@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("np_dtype", DTYPES, ids=("f64", "f32"))
@pytest.mark.parametrize("seed", range(4))
def test_sharded_select_matches_jax(seed, np_dtype, mesh_shape):
    inp = _as_dtype(_random_inputs(np.random.default_rng(seed)), np_dtype,
                    _SELECT_FLOATS)
    want = _jax_select()(inp)
    port_inp = tscore.ScoreInputs(**inp._asdict())
    evals, nodes = mesh_shape
    got = sharded_score_and_select(VirtualMesh(nodes, "cpu", n_evals=evals))(
        port_inp)
    _same_select(got, want)
    # and the port's unsharded select on the same inputs
    whole = tscore.ScoreInputs(**{
        k: torch.from_numpy(np.asarray(v)) if k in tscore._COLUMNS else v
        for k, v in inp._asdict().items()})
    _same_select(got, tscore.score_and_select(whole))


@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("np_dtype", DTYPES, ids=("f64", "f32"))
def test_sharded_batch_plan_matches_jax(np_dtype, mesh_shape):
    from nomad_tpu.parallel import sharded_batch_plan as jax_plan

    batch = _as_dtype(_batch_inputs(np.random.default_rng(1), E=E), np_dtype,
                      _BATCH_FLOATS)
    cols = tuple(np.full(C, v, np_dtype) for v in (4000.0, 8192.0, 100_000.0))
    want = np.asarray(jax_plan(_jax_mesh(), n_candidates=N_ACTIVE, n_picks=P)(
        *cols, batch))
    port_batch = tbatch.BatchInputs(*batch)
    evals, nodes = mesh_shape
    mesh = VirtualMesh(nodes, "cpu", n_evals=evals)
    got = sharded_batch_plan(mesh, n_candidates=N_ACTIVE, n_picks=P)(
        *cols, port_batch)
    assert got.dtype == torch.int32 and tuple(got.shape) == (E, P)
    np.testing.assert_array_equal(got.numpy(), want)
    twin = tbatch.batch_plan_picks(
        *(torch.from_numpy(c) for c in cols), port_batch, N_ACTIVE, P)
    assert torch.equal(got, twin)
    assert bool((got >= 0).all())


def test_policy_inputs_raise_on_both_sides():
    """The JAX program's in_specs leave `policy` out, so a ScoreInputs
    with policy terms fits neither program."""
    from nomad_tpu.ops.score import PolicyTerms as JaxPolicy

    inp = _random_inputs(np.random.default_rng(0))
    tput = np.linspace(0.0, 1.0, C)
    with pytest.raises((ValueError, TypeError)):
        _jax_select()(inp._replace(policy=JaxPolicy(
            tput_term=tput, has_tput=np.float64(1.0), mig_term=None)))
    port = tscore.ScoreInputs(**inp._asdict())._replace(
        policy=tscore.PolicyTerms(tput_term=torch.from_numpy(tput),
                                  has_tput=1.0))
    with pytest.raises(ValueError, match="policy"):
        sharded_score_and_select(VirtualMesh(4, "cpu", n_evals=2))(port)


def test_shapes_that_do_not_split_raise():
    """An E not divisible by the eval axis, or a C by the node axis,
    raises, as the JAX shardings do."""
    batch = tbatch.BatchInputs(*_batch_inputs(np.random.default_rng(1), E=3))
    cols = tuple(np.full(C, v) for v in (4000.0, 8192.0, 100_000.0))
    with pytest.raises(ValueError, match="eval rows"):
        sharded_batch_plan(VirtualMesh(4, "cpu", n_evals=2), N_ACTIVE, P)(
            *cols, batch)
    with pytest.raises(ValueError, match="equal shards"):
        sharded_batch_plan(VirtualMesh(3, "cpu"), N_ACTIVE, P)(*cols, batch)
    inp = tscore.ScoreInputs(**_random_inputs(np.random.default_rng(0))._asdict())
    with pytest.raises(ValueError, match="equal shards"):
        sharded_score_and_select(VirtualMesh(3, "cpu"))(inp)


def test_virtual_mesh_equals_gloo_ranks_2x2(tmp_path):
    """A 2 x 2 DistMesh over four gloo ranks (`make_mesh()`, the JAX
    default axes) runs the select and the batched planner and gets, on
    every rank, what the 2 x 2 VirtualMesh gets; the ranks load neither
    JAX nor the JAX package."""
    world = 4
    init = tmp_path / "init"
    _spawn(world, torch_mesh_ranks.eval_rank_main,
           lambda r: (r, world, str(init), str(tmp_path)))
    want = torch_mesh_ranks.eval_mesh_results(VirtualMesh(2, "cpu", n_evals=2))
    for rank in range(world):
        got = torch.load(tmp_path / f"eval{rank}.pt")
        assert got.pop("loaded") == []
        assert got.pop("mesh") == (2, 2, (rank // 2,), (rank % 2,))
        assert got.keys() == want.keys()
        for key in want:
            for a, b in zip(got[key], want[key]):
                assert a.dtype == b.dtype and torch.equal(a, b), (rank, key)
