"""Port parity on the Go bridge path.

* The plain twin of kernel K7, `batch_plan_picks_shared_twin`, against
  the JAX program it replaces, `nomad_tpu.ops.batch.
  batch_plan_picks_shared`, on every `ops/cases.py batch_shared_case`
  scenario, f64 and f32: the whole [E, P] rows, exact.
* The port's `BridgeService` against the JAX package's on one world: a
  JAX store with mock nodes and allocs, a deregistered node (a hole in
  the arena), an ineligible node and a down node, carried into a port
  `Server(device="cpu", num_schedulers=0)` with `load_cluster`.  The
  same `ScoreBatch` and `Ping` bodies through both services, over the
  framed wire protocol, must give equal responses.
"""
import math
import random
import socket

import numpy as np
import pytest
import torch

from nomad_tpu import mock as jmock
from nomad_tpu import wire as jwire
from nomad_tpu.api.codec import alloc_to_dict, job_to_dict, node_to_dict
from nomad_tpu.ops import batch as jbatch
from nomad_tpu.server import Server as JServer
from nomad_tpu.server.bridge_service import BridgeService as JBridge
from nomad_tpu.structs import (
    AllocatedResources,
    AllocatedSharedResources,
    AllocatedTaskResources,
    Allocation,
    alloc_name,
)
from nomad_tpu_torch import wire as twire
from nomad_tpu_torch.ops import batch as tbatch
from nomad_tpu_torch.ops.cases import (
    BATCH_SHARED_SCENARIOS,
    batch_shared_case,
    service_limit,
)
from nomad_tpu_torch.server import Server as TServer
from nomad_tpu_torch.server.bridge_service import BridgeService as TBridge
from nomad_tpu_torch.state.convert import (
    batch_inputs_from_numpy,
    batch_shared_inputs_from_numpy,
    load_cluster,
)

C = 256
NP_DTYPE = {torch.float64: np.float64, torch.float32: np.float32}
_ARGS = ("cpu_total", "mem_total", "disk_total", "feasible",
         "base_cpu_used", "base_mem_used", "base_disk_used", "perms",
         "ask_cpu", "ask_mem", "ask_disk", "desired_count", "limit")


# ---------------------------------------------------------------------------
# ops/batch.py: the twin against the JAX program
# ---------------------------------------------------------------------------


def run_jax(case, dtype):
    f = NP_DTYPE[dtype]
    args = [case[k].astype(f) if case[k].dtype.kind == "f" else case[k]
            for k in _ARGS]
    return np.asarray(jbatch.batch_plan_picks_shared(
        *args, np.int32(case["n_candidates"]), case["n_picks"]
    ))


def run_port(case, dtype):
    kw = batch_shared_inputs_from_numpy(case, "cpu", dtype)
    return tbatch.batch_plan_picks_shared(**kw).numpy()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("E,P", [(1, 1), (6, 10), (3, 16)])
@pytest.mark.parametrize("n_cand", [1, 5, 200, C])
@pytest.mark.parametrize("scenario", BATCH_SHARED_SCENARIOS)
def test_batch_plan_picks_shared_matches_jax(scenario, n_cand, E, P, dtype):
    seed = 4000 + 10 * BATCH_SHARED_SCENARIOS.index(scenario) + n_cand + E
    case = batch_shared_case(seed, C, n_cand, scenario, E, P)
    want = run_jax(case, dtype)
    got = run_port(case, dtype)
    assert got.dtype == np.int32 and got.shape == (E, P)
    np.testing.assert_array_equal(got, want)
    if scenario == "fit_nowhere":
        assert (got == tbatch.NO_NODE).all()
    if scenario == "tight" and n_cand == C and P == 16:
        # evals run out of room part way, and stay out
        assert (got == tbatch.NO_NODE).any() and (got >= 0).any()
        for row in got:
            fail = np.flatnonzero(row == tbatch.NO_NODE)
            if len(fail):
                assert (row[fail[0]:] == tbatch.NO_NODE).all()


@pytest.mark.parametrize("spread_fit", [False, True])
@pytest.mark.parametrize("scenario", BATCH_SHARED_SCENARIOS)
def test_twin_is_e_independent_plan_picks(scenario, spread_fit):
    """Row k of the batched twin is `plan_picks` (K2's twin, rows only)
    of eval k alone over the shared columns, and equals the JAX
    program's row under either fit."""
    case = batch_shared_case(4100 + BATCH_SHARED_SCENARIOS.index(scenario),
                             C, 120, scenario, 5, 12)
    kw = batch_shared_inputs_from_numpy(case, "cpu")
    got = tbatch.batch_plan_picks_shared(**kw, spread_fit=spread_fit)
    zeros = np.zeros(C)
    for k in range(5):
        inp = batch_inputs_from_numpy(dict(
            feasible=case["feasible"], base_cpu_used=case["base_cpu_used"],
            base_mem_used=case["base_mem_used"],
            base_disk_used=case["base_disk_used"],
            base_collisions=zeros.astype(np.int32),
            penalty=zeros.astype(bool), affinity_score=zeros,
            perm=case["perms"][k], ask_cpu=case["ask_cpu"][k],
            ask_mem=case["ask_mem"][k], ask_disk=case["ask_disk"][k],
            desired_count=case["desired_count"][k], limit=case["limit"][k],
            distinct_hosts=False,
        ), "cpu")
        one = tbatch.plan_picks(kw["cpu_total"], kw["mem_total"],
                                kw["disk_total"], inp, 120, 12, spread_fit)
        assert torch.equal(got[k], one)
    want = np.asarray(jbatch.batch_plan_picks_shared(
        *[case[k] for k in _ARGS], np.int32(120), 12, spread_fit=spread_fit
    ))
    np.testing.assert_array_equal(got.numpy(), want)


def test_anti_affinity_divides_by_the_evals_count():
    """Two evals with one walk order and one ask over two candidates: A
    nearly full (binpack scores it near 1) and B empty.  Both first
    pick A.  A second pick on A scores (fitness / 18 - 2 / count) / 2:
    below zero for the count-1 eval, which goes to B, and still above
    B's score for the count-10 eval, which stays on A.  The surplus
    picks of the count-1 eval are computed all the same."""
    case = batch_shared_case(17, C, 2, "bridge", 2, 10)
    a, b = case["perms"][0, :2]
    case["perms"][1] = case["perms"][0]
    for col, full in (("cpu_total", 16000.0), ("mem_total", 16384.0)):
        case[col][[a, b]] = full
    case["base_cpu_used"][[a, b]] = (15000.0, 0.0)
    case["base_mem_used"][[a, b]] = (15000.0, 0.0)
    case["disk_total"][[a, b]] = 1e6
    case["ask_cpu"][:] = 100.0
    case["ask_mem"][:] = 100.0
    case["desired_count"][:] = (1, 10)
    got = run_port(case, torch.float64)
    np.testing.assert_array_equal(got, run_jax(case, torch.float64))
    assert got[0, 0] == got[1, 0] == a
    assert got[0, 1] == b and got[1, 1] == a


def test_no_evals_launch_nothing():
    case = batch_shared_case(3, C, 20, "mixed", 2, 4)
    kw = batch_shared_inputs_from_numpy(case, "cpu")
    per_eval = ("perms", "ask_cpu", "ask_mem", "ask_disk", "desired_count",
                "limit")
    no_evals = dict(kw, **{k: kw[k][:0] for k in per_eval})
    assert tuple(tbatch.batch_plan_picks_shared(**no_evals).shape) == (0, 4)


def test_wrapper_rejects_bad_inputs():
    case = batch_shared_case(4, C, 20, "mixed", 2, 4)
    kw = batch_shared_inputs_from_numpy(case, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        tbatch.batch_plan_picks_shared_cuda(**kw)
    with pytest.raises(TypeError):
        tbatch.batch_plan_picks_shared(**dict(kw, ask_cpu=kw["ask_cpu"].float()))
    with pytest.raises(TypeError):
        tbatch.batch_plan_picks_shared(**dict(kw, perms=kw["perms"].long()))
    with pytest.raises(ValueError, match="shape"):
        tbatch.batch_plan_picks_shared(**dict(kw, limit=kw["limit"][:1]))
    with pytest.raises(ValueError, match="n_candidates"):
        tbatch.batch_plan_picks_shared(**dict(kw, n_candidates=C + 1))
    with pytest.raises(ValueError, match="n_picks"):
        tbatch.batch_plan_picks_shared(**dict(kw, n_picks=0))


def test_service_limit_is_the_bridges():
    for n in (1, 2, 3, 9, 10_000, 16_384):
        assert service_limit(n) == max(2, math.ceil(math.log2(n)))


# ---------------------------------------------------------------------------
# the bridge service: the port's against the JAX package's
# ---------------------------------------------------------------------------


def jax_world(n_nodes=12, n_allocs=40, seed=5, hole=3, ineligible=5,
              down=7):
    """A JAX store of mock nodes (explicit ids and mixed sizes) with
    filler allocs, then node `hole` deregistered (its arena row stays
    free), node `ineligible` marked ineligible and node `down` down.
    Returns (server, {row: deregistered node})."""
    rng = random.Random(seed)
    server = JServer(num_schedulers=0, heartbeat_ttl=1e9, seed=seed)
    store = server.store
    nodes = []
    for i in range(n_nodes):
        n = jmock.node(id=f"bridge-{seed}-{i:02d}")
        n.node_resources.cpu = rng.choice([2000, 4000, 8000])
        n.node_resources.memory_mb = rng.choice([4096, 8192, 16384])
        nodes.append(n)
        store.upsert_node(n)
    filler = jmock.job(id="filler")
    store.upsert_job(filler)
    allocs = []
    for i in range(n_allocs):
        node = nodes[rng.randrange(n_nodes)]
        allocs.append(Allocation(
            id=f"filler-{i:04d}", namespace="default", job_id="filler",
            job=filler, task_group="web", name=alloc_name("filler", "web", i),
            node_id=node.id,
            allocated_resources=AllocatedResources(
                tasks={"web": AllocatedTaskResources(
                    cpu=rng.choice([100, 250, 500]),
                    memory_mb=rng.choice([128, 256, 512]),
                )},
                shared=AllocatedSharedResources(disk_mb=100),
            ),
            client_status="running",
        ))
    store.upsert_allocs(allocs)
    deleted = {}
    if hole is not None:
        deleted[store.node_table.row_of[nodes[hole].id]] = nodes[hole]
        store.delete_node(nodes[hole].id)
    if ineligible is not None:
        store.update_node_eligibility(nodes[ineligible].id, "ineligible")
    if down is not None:
        store.update_node_status(nodes[down].id, "down")
    return server, deleted


def carry(jserver, deleted):
    """The JAX world as a port `Server(device="cpu")`: nodes in arena row
    order (a deregistered node inserted at its row, then deleted, so the
    hole stays), the jobs, then the allocs."""
    s = jserver.store
    table = s.node_table
    nodes = []
    for row in range(table.n_rows):
        nid = table.node_ids[row]
        nodes.append(node_to_dict(s.nodes[nid] if nid else deleted[row]))
    jobs = [job_to_dict(j) for vs in s.job_versions.values()
            for j in reversed(vs)]
    store = load_cluster(nodes, jobs,
                         [alloc_to_dict(a) for a in s.allocs.values()])
    for node in deleted.values():
        store.delete_node(node.id)
    return TServer(num_schedulers=0, device="cpu", heartbeat_ttl=1e9,
                   store=store)


@pytest.fixture
def services():
    opened = []

    def open_pair(**world):
        jserver, deleted = jax_world(**world)
        tserver = carry(jserver, deleted)
        jt, tt = jserver.store.node_table, tserver.store.node_table
        # the carried arena is the source's, hole included
        assert tt.row_of == jt.row_of
        assert tt.capacity == jt.capacity
        for name in ("eligible", "cpu_total", "mem_total", "disk_total",
                     "cpu_used", "mem_used", "disk_used"):
            np.testing.assert_array_equal(getattr(tt, name),
                                          getattr(jt, name))
        pair = (JBridge(jserver, port=0), TBridge(tserver, port=0))
        for svc in pair:
            svc.start()
            opened.append(svc)
        return pair

    yield open_pair
    for svc in opened:
        svc.stop()


def call(module, service, method, body):
    sock = socket.create_connection(("127.0.0.1", service.port))
    try:
        return module.call(sock, method, body)
    finally:
        sock.close()


def evals(seed, n, counts=(1, 10), cpu=(100, 2000), mem=(128, 2048)):
    rng = random.Random(seed)
    return {"evals": [
        {"eval_id": f"ev-{seed}-{k}", "job_id": f"job-{k}",
         "seed": rng.randrange(2**31), "count": rng.choice(counts),
         "cpu": rng.randint(*cpu), "memory_mb": rng.randint(*mem),
         "disk_mb": 300}
        for k in range(n)
    ]}


BODIES = {
    "mixed_counts": evals(1, 8),
    "count_over_candidates": evals(2, 3, counts=(20, 25)),
    "fit_nowhere": evals(3, 4, cpu=(10**6, 2 * 10**6)),
    "defaults": {"evals": [{"eval_id": "bare"}, {"seed": 9, "count": 3}]},
    "no_evals": {"evals": []},
    "empty_body": {},
}


@pytest.mark.parametrize("name", sorted(BODIES))
def test_score_batch_matches_jax_service(services, name):
    jsvc, tsvc = services()
    body = BODIES[name]
    want = call(jwire, jsvc, "TPUScheduler.ScoreBatch", body)
    got = call(twire, tsvc, "TPUScheduler.ScoreBatch", body)
    assert got == want
    assert "error" not in got
    placed = [n for r in got["results"] for n in r["nodes"]]
    if name == "mixed_counts":
        assert placed and len(placed) < sum(e["count"] for e in body["evals"]) + 1
    if name == "count_over_candidates":
        # more picks than eligible nodes: nodes repeat within an eval
        assert any(len(set(r["nodes"])) < len(r["nodes"])
                   for r in got["results"])
    if name == "fit_nowhere":
        assert placed == []


def test_score_batch_skips_hole_ineligible_and_down(services):
    jsvc, tsvc = services()
    body = evals(4, 16, counts=(10,))
    got = call(twire, tsvc, "TPUScheduler.ScoreBatch", body)
    assert got == call(jwire, jsvc, "TPUScheduler.ScoreBatch", body)
    placed = {n for r in got["results"] for n in r["nodes"]}
    assert placed
    for i in (3, 5, 7):
        assert f"bridge-5-{i:02d}" not in placed


def test_score_batch_with_no_eligible_node(services):
    jsvc, tsvc = services(n_nodes=2, n_allocs=4, hole=None, ineligible=0,
                          down=1)
    body = evals(5, 3)
    got = call(twire, tsvc, "TPUScheduler.ScoreBatch", body)
    assert got == call(jwire, jsvc, "TPUScheduler.ScoreBatch", body)
    assert all(r["nodes"] == [] for r in got["results"])


def test_batch_of_zero_counts_is_an_error_on_both(services):
    """No eval asks for a placement: the JAX service fails in its pick
    scan of length 0 and answers an error; so does the port's."""
    jsvc, tsvc = services()
    body = {"evals": [{"eval_id": "z0", "count": 0},
                      {"eval_id": "z1", "count": 0, "seed": 4}]}
    want = call(jwire, jsvc, "TPUScheduler.ScoreBatch", body)
    got = call(twire, tsvc, "TPUScheduler.ScoreBatch", body)
    assert list(want) == list(got) == ["error"]


def test_ping_and_unknown_method_match_jax_service(services):
    jsvc, tsvc = services()
    for method in ("TPUScheduler.Ping", "Nope.Nope"):
        want = call(jwire, jsvc, method, {})
        got = call(twire, tsvc, method, {})
        assert got == want
    assert "error" in call(twire, tsvc, "Nope.Nope", {})


def test_exception_becomes_error_response(services, monkeypatch):
    """A failure of the pick program reaches the caller as the service's
    error response, as a JAX exception does; nothing answers for it."""
    _jsvc, tsvc = services()

    def boom(**kw):
        raise RuntimeError("nk_batch_picks launch failed")

    from nomad_tpu_torch.server import bridge_service

    monkeypatch.setattr(bridge_service, "batch_plan_picks_shared", boom)
    got = call(twire, tsvc, "TPUScheduler.ScoreBatch", evals(6, 2))
    assert got == {"error": "RuntimeError: nk_batch_picks launch failed"}
    # the connection's thread keeps serving
    assert call(twire, tsvc, "TPUScheduler.Ping", {})["ok"] is True


def test_one_connection_serves_many_calls(services):
    jsvc, tsvc = services()
    sock = socket.create_connection(("127.0.0.1", tsvc.port))
    try:
        for seed in range(3):
            body = evals(10 + seed, 4)
            got = twire.call(sock, "TPUScheduler.ScoreBatch", body)
            assert got == call(jwire, jsvc, "TPUScheduler.ScoreBatch", body)
    finally:
        sock.close()
