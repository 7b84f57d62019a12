"""The port's entry module (`nomad_tpu_torch/entry.py`) against the JAX
package's (`__graft_entry__.py`).

`entry("cpu")`'s step on its example inputs gives the JAX `entry()`'s
(row, best, feasible count, pulls), exactly; its inputs are the same
numpy draws.  `dryrun_multichip(8, "cpu")` runs on the (2, 4) mesh the
JAX `make_mesh(8)` builds and returns a select and [E, P] rows equal to
what the JAX `sharded_score_and_select` and `sharded_batch_plan` give on
the JAX dryrun's own inputs (its recipe repeated here), and places both
jobs through the meshed batched Server.  Without a card, the entry
points' default device raises."""
import numpy as np
import pytest
import torch

from nomad_tpu_torch.entry import _example_inputs, dryrun_multichip, entry


def _bits(x):
    a = np.asarray(x)
    return a.view(np.int64 if a.dtype == np.float64 else np.int32).item()


def _select_key(out):
    row, best, n, pulls = (np.asarray(x) for x in out)
    return int(row), str(best.dtype), _bits(best), int(n), int(pulls)


def test_entry_matches_jax():
    import __graft_entry__ as jentry

    fn, args = entry("cpu")
    jfn, jargs = jentry.entry()
    assert _select_key(fn(*args)) == _select_key(jfn(*jargs))
    # the example inputs are the JAX module's draws
    got, want = args[0], jargs[0]
    for field in want._fields:
        a, b = getattr(got, field), getattr(want, field)
        if field == "policy":
            assert a is None and b is None
        elif isinstance(a, torch.Tensor):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            assert a.numpy().dtype == np.asarray(b).dtype
        else:
            assert a == b


def _jax_dryrun_batch(C, n_active, E, P_):
    """The batch of `__graft_entry__.dryrun_multichip`, drawn as it draws
    it (rng(2), one eval after another)."""
    from nomad_tpu.ops.batch import BatchInputs

    rng = np.random.default_rng(2)

    def one_eval():
        feas = np.zeros(C, dtype=bool)
        feas[:n_active] = True
        used = np.zeros(C, np.float32)
        used[:n_active] = rng.integers(0, 1000, n_active)
        perm = np.concatenate(
            [rng.permutation(n_active), np.arange(n_active, C)]
        ).astype(np.int32)
        return BatchInputs(
            feasible=feas, base_cpu_used=used, base_mem_used=used.copy(),
            base_disk_used=np.zeros(C, np.float32),
            base_collisions=np.zeros(C, np.int32),
            penalty=np.zeros(C, dtype=bool),
            affinity_score=np.zeros(C, np.float32), perm=perm,
            ask_cpu=np.float32(500.0), ask_mem=np.float32(256.0),
            ask_disk=np.float32(300.0), desired_count=np.int32(P_),
            limit=np.int32(9), distinct_hosts=np.bool_(False),
        )

    evals = [one_eval() for _ in range(E)]
    return BatchInputs(*[np.stack([getattr(e, f) for e in evals])
                         for f in BatchInputs._fields])


def test_dryrun_matches_the_jax_programs():
    import __graft_entry__ as jentry
    from nomad_tpu.parallel import (
        make_mesh,
        sharded_batch_plan,
        sharded_score_and_select,
    )

    got = dryrun_multichip(8, "cpu")
    mesh = make_mesh(8)
    assert got["axes"] == tuple(mesh.devices.shape) == (2, 4)
    node_axis, eval_axis = mesh.shape["nodes"], mesh.shape["evals"]
    C = 64 * node_axis
    n_active = C - 8
    E, P_ = 2 * eval_axis, 3
    want = sharded_score_and_select(mesh)(
        jentry._example_inputs(C=C, n_active=n_active, seed=1))
    assert _select_key(got["select"]) == _select_key(want)
    cols = (np.full(C, 4000.0, np.float32), np.full(C, 8192.0, np.float32),
            np.full(C, 100_000.0, np.float32))
    rows = sharded_batch_plan(mesh, n_candidates=n_active, n_picks=P_)(
        *cols, _jax_dryrun_batch(C, n_active, E, P_))
    assert got["rows"].dtype == torch.int32
    np.testing.assert_array_equal(got["rows"].numpy(), np.asarray(rows))
    # the meshed Server placed both count-4 jobs on the fixed-name nodes
    placements = got["placements"]
    assert sorted(placements) == sorted(
        [f"dryrun-job.web[{i}]" for i in range(4)]
        + [f"dryrun-spread.web[{i}]" for i in range(4)])
    assert all(v.startswith("dryrun-node-") for v in placements.values())
    stats = got["worker"]
    assert stats["prescored"] >= 1 and stats["errors"] == 0
    assert stats["mesh_used"] >= 2


def test_dryrun_repeats_itself():
    """Two CPU runs give the same select, rows and placements: what the
    card run is compared with."""
    a = dryrun_multichip(8, "cpu")
    b = dryrun_multichip(8, "cpu")
    assert _select_key(a["select"]) == _select_key(b["select"])
    assert torch.equal(a["rows"], b["rows"])
    assert a["placements"] == b["placements"]


@pytest.mark.parametrize("n", (1, 2, 4))
def test_dryrun_on_smaller_meshes(n):
    """Every default mesh the dryrun builds places its jobs: n = 1 and 2
    are one eval row, 4 is 2 x 2."""
    got = dryrun_multichip(n, "cpu")
    assert got["axes"] == ((2, n // 2) if n >= 4 else (1, n))
    assert tuple(got["rows"].shape) == (2 * got["axes"][0], 3)
    assert len(got["placements"]) == 8


def test_entry_points_default_to_the_card():
    from nomad_tpu_torch.device import NoDeviceError

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(NoDeviceError):
        entry()
    with pytest.raises(NoDeviceError):
        dryrun_multichip(8)
    assert _example_inputs().cpu_total.device.type == "cpu"


def test_batch_worker_loads_its_kernels_before_its_stages(monkeypatch):
    """On the card, a batched Server's worker builds and loads the kernels
    of its watchdog-guarded stages (K3, K4, K5; K12-K14 on a mesh) when
    it starts, before its thread runs: a first nvcc inside a stage took
    longer than the stage's 5 s budget and tripped a healthy card (the
    dryrun's meshed Server in `mesh_launch`).  On the CPU nothing is
    built."""
    from nomad_tpu_torch.ops import _cuda
    from nomad_tpu_torch.parallel import VirtualMesh
    from nomad_tpu_torch.server import Server
    from nomad_tpu_torch.server.worker import Worker

    order = []
    monkeypatch.setattr(_cuda, "load", lambda names: order.append(list(names)))
    server = Server(batch_pipeline=True, device="cpu", heartbeat_ttl=1e9,
                    mesh=VirtualMesh(2, "cpu"))
    worker = server.workers[0]
    server.start()
    server.stop()
    assert order == []
    monkeypatch.setattr(worker, "device", torch.device("cuda"))
    monkeypatch.setattr(Worker, "start", lambda self: order.append("thread"))
    worker.start()
    assert order == [["chained_picks", "patch_rows_mesh", "storm_solve",
                      "sharded_chain", "storm_sharded"],
                     "thread"]
    plain = Server(batch_pipeline=True, device="cpu", heartbeat_ttl=1e9)
    monkeypatch.setattr(plain.workers[0], "device", torch.device("cuda"))
    order.clear()
    plain.workers[0].start()
    assert order == [["chained_picks", "patch_rows_mesh", "storm_solve"],
                     "thread"]
