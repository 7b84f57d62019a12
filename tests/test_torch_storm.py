"""Port parity: the global storm solver (NOMAD_TPU_STORM=1).

- The plain twin of kernel K5, `nomad_tpu_torch.ops.solve
  .storm_assignment_twin`, against the JAX program it replaces,
  `nomad_tpu.ops.solve.storm_assignment`, on the seeded cases of
  `ops/cases.py storm_case`: all six outputs bit-equal, f64 and f32.
- The broker's family drain against the JAX broker's.
- The port's storm `Server` (BatchWorker -> build_storm_problem -> the
  twin -> decompose -> prescored replay) against the JAX storm
  `Server`: equal placements and equal storm counters.
- A failing solve stops the worker with DeviceFault; a weighted storm
  (policy rows staged into the solve) places as the JAX storm Server.
"""
import copy
import random
import types

import numpy as np
import pytest
import torch

import nomad_tpu.mock as jmock
import nomad_tpu.structs as jstructs
import nomad_tpu_torch.mock as tmock
import nomad_tpu_torch.structs as tstructs
from nomad_tpu.ops import score as jscore
from nomad_tpu.ops import solve as jsolve
from nomad_tpu.server import EvalBroker as JaxBroker
from nomad_tpu.server import Server as JaxServer
from nomad_tpu.server.eval_broker import job_family as jax_job_family
from nomad_tpu_torch.ops import score as tscore
from nomad_tpu_torch.ops import solve as tsolve
from nomad_tpu_torch.ops.cases import STORM_SCENARIOS, storm_case
from nomad_tpu_torch.server import EvalBroker as TorchBroker
from nomad_tpu_torch.server import Server as TorchServer
from nomad_tpu_torch.server.eval_broker import job_family as torch_job_family
from nomad_tpu_torch.state.convert import storm_columns, storm_inputs

JAX = types.SimpleNamespace(mock=jmock, structs=jstructs, Server=JaxServer,
                            Broker=JaxBroker, job_family=jax_job_family)
TORCH = types.SimpleNamespace(mock=tmock, structs=tstructs,
                              Server=TorchServer, Broker=TorchBroker,
                              job_family=torch_job_family)

E, A, C = 4, 32, 128
COLS = ("cpu_total", "mem_total", "disk_total", "cpu_used", "mem_used",
        "disk_used")
NP_DTYPE = {torch.float64: np.float64, torch.float32: np.float32}


# ---------------------------------------------------------------------------
# ops/solve.py: the twin against the JAX program
# ---------------------------------------------------------------------------


def run_jax(cols, inp, max_rounds, spread_fit, dtype):
    f = NP_DTYPE[dtype]
    jin = jsolve.StormInputs(**{
        k: v.astype(f) if v.dtype.kind == "f" else v for k, v in inp.items()
    })
    out = jsolve.storm_assignment(
        jin, tuple(cols[k].astype(f) for k in COLS),
        spread_fit=spread_fit, max_rounds=max_rounds,
    )
    return [np.asarray(x) for x in out]


def run_twin(cols, inp, max_rounds, spread_fit, dtype):
    out = tsolve.storm_assignment(
        storm_inputs(inp, "cpu", dtype), storm_columns(cols, "cpu", dtype),
        spread_fit, max_rounds,
    )
    return [x.numpy() for x in out]


def assert_bits_equal(got, want, dtype):
    assert len(got) == len(want) == 6
    for name, g, w in zip(tsolve.StormOut._fields, got, want):
        if name == "score":
            assert g.dtype == w.dtype == NP_DTYPE[dtype]
            view = np.int64 if g.dtype == np.float64 else np.int32
            np.testing.assert_array_equal(g.view(view), w.view(view),
                                          err_msg=name)
        else:
            assert g.dtype == np.int32, name
            np.testing.assert_array_equal(g, w.astype(np.int32),
                                          err_msg=name)


@pytest.mark.parametrize("spread_fit", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("scenario", STORM_SCENARIOS)
def test_storm_assignment_matches_jax(scenario, dtype, spread_fit):
    seed = 700 + STORM_SCENARIOS.index(scenario)
    cols, inp, max_rounds = storm_case(seed, E, A, C, scenario)
    want = run_jax(cols, inp, max_rounds, spread_fit, dtype)
    got = run_twin(cols, inp, max_rounds, spread_fit, dtype)
    assert_bits_equal(got, want, dtype)
    rounds = int(want[5])
    assigned = want[0]
    if scenario in ("dogpile", "ties", "pre_deltas"):
        # the auction runs for several rounds (not just the warm start)
        assert rounds >= 3
        assert (want[2] >= 2).any()
    if scenario.startswith("round_budget"):
        assert rounds == max_rounds
        assert (assigned == -1).any(), "the budget should leave rows unsolved"
    if scenario == "padding_rows":
        assert (assigned[~inp["real"]] == -1).all()
        assert (want[4][~inp["real"]] == -1).all()
    if scenario == "infeasible_rows":
        assert (assigned == -1).any()
        assert (want[2][assigned == -1] == -1).all()
    if scenario == "uncontended":
        # room everywhere: almost every row keeps its walk winner
        assert (assigned >= 0).all()
        assert (assigned == want[4]).mean() > 0.5


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_one_row_storm_is_the_walk(seed, dtype):
    """The degenerate-parity contract: a one-row storm's assignment and
    pulls are the serial limited walk's, through the port's own
    `limited_walk_argmax` over the same score vector."""
    cols, inp, max_rounds = storm_case(seed, 1, 1, C, "one_row")
    sinp = storm_inputs(inp, "cpu", dtype)
    scols = storm_columns(cols, "cpu", dtype)
    out = tsolve.storm_assignment(sinp, scols, False, max_rounds)
    feas, scores, si = tsolve.storm_scores(sinp, scols, False)
    row, _best, _n, pulls = tscore.limited_walk_argmax(
        feas[0], scores[0], si.perm[0], si.limit[0], si.n_candidates[0]
    )
    assert int(out.assigned[0]) == int(row) == int(out.greedy[0])
    assert int(out.pulls[0]) == int(pulls)
    assert int(out.accept_round[0]) == (0 if int(row) >= 0 else -1)


@pytest.mark.parametrize("scenario", ["penalty_affinity_collisions",
                                      "infeasible_rows", "pre_deltas"])
def test_walk_rows_is_the_per_row_walk(scenario):
    """The twin's batched warm start equals `limited_walk_argmax` run
    row by row (the JAX program vmaps it)."""
    cols, inp, _mr = storm_case(41, E, A, C, scenario)
    sinp = storm_inputs(inp, "cpu")
    feas, scores, si = tsolve.storm_scores(sinp, storm_columns(cols, "cpu"),
                                           False)
    rows, pulls = tsolve._walk_rows(feas, scores, si.perm, si.limit,
                                    si.n_candidates)
    for a in range(A):
        row, _b, _n, p = tscore.limited_walk_argmax(
            feas[a], scores[a], si.perm[a], si.limit[a], si.n_candidates[a]
        )
        assert (int(rows[a]), int(pulls[a])) == (int(row), int(p))


def test_storm_scores_are_the_serial_scores():
    """Each row of the broadcast score matrix is the serial chain's
    score vector of that row (`score_vectors` with scalar asks), and
    the JAX program's broadcast `_score_vectors` agrees bit for bit."""
    cols, inp, _mr = storm_case(43, E, A, C, "penalty_affinity_collisions")
    sinp = storm_inputs(inp, "cpu")
    scols = storm_columns(cols, "cpu")
    feas, scores, si = tsolve.storm_scores(sinp, scols, False)
    for a in (0, 7, A - 1):
        one = tscore.ScoreInputs(
            cpu_total=scols[0], mem_total=scols[1], disk_total=scols[2],
            cpu_used=si.cpu_used, mem_used=si.mem_used,
            disk_used=si.disk_used, feasible=si.feasible[a],
            collisions=si.collisions[a], penalty=si.penalty[a],
            affinity_score=si.affinity_score[a],
            spread_boost=torch.zeros(C, dtype=torch.float64),
            perm=si.perm[a], ask_cpu=float(inp["ask"][a, 0]),
            ask_mem=float(inp["ask"][a, 1]), ask_disk=float(inp["ask"][a, 2]),
            desired_count=int(inp["desired"][a]), limit=int(si.limit[a]),
            n_candidates=int(si.n_candidates[a]),
        )
        f1, s1 = tscore.score_vectors(one)
        assert torch.equal(f1 & sinp.real[a], feas[a])
        assert torch.equal(s1.view(torch.int64), scores[a].view(torch.int64))
    eo = inp["eval_of"]
    jsi = jscore.ScoreInputs(
        cpu_total=cols["cpu_total"], mem_total=cols["mem_total"],
        disk_total=cols["disk_total"],
        cpu_used=cols["cpu_used"] + inp["pre_cpu"],
        mem_used=cols["mem_used"] + inp["pre_mem"],
        disk_used=cols["disk_used"] + inp["pre_disk"],
        feasible=inp["feasible"][eo], collisions=inp["collisions"][eo],
        penalty=inp["penalty"], affinity_score=inp["affinity"][eo],
        spread_boost=np.zeros((), np.float64), perm=inp["perm"][eo],
        ask_cpu=inp["ask"][:, 0:1], ask_mem=inp["ask"][:, 1:2],
        ask_disk=inp["ask"][:, 2:3], desired_count=inp["desired"][:, None],
        limit=inp["limit"][eo], n_candidates=inp["n_cand"][eo],
    )
    _jf, js = jscore.score_all(jsi, spread_fit=False)
    np.testing.assert_array_equal(np.asarray(js).view(np.int64),
                                  scores.numpy().view(np.int64))


def test_policy_terms_raise():
    """A half-staged policy (one of the three fields) is refused; all
    three give the JAX program's weighted solve, and all-zero rows the
    unweighted one."""
    cols, inp, mr = storm_case(5, E, A, C, "uncontended")
    sinp = storm_inputs(inp, "cpu")._replace(
        policy_tput_term=torch.zeros((E, C), dtype=torch.float64)
    )
    with pytest.raises(ValueError):
        tsolve.storm_assignment(sinp, storm_columns(cols, "cpu"), False, mr)
    rng = np.random.default_rng(5)
    weighted = dict(
        inp,
        policy_tput_term=np.where(rng.random((E, C)) < 0.5, 0.75, 0.25),
        policy_has_tput=np.asarray([1.0, 0.0, 1.0, 1.0]),
        policy_mig_term=np.where(rng.random((E, C)) < 0.9, -0.5, 0.0),
    )
    weighted["policy_tput_term"][1] = 0.0
    want = run_jax(cols, weighted, mr, False, torch.float64)
    assert_bits_equal(run_twin(cols, weighted, mr, False, torch.float64),
                      want, torch.float64)
    zeros = dict(inp, policy_tput_term=np.zeros((E, C)),
                 policy_has_tput=np.zeros(E),
                 policy_mig_term=np.zeros((E, C)))
    assert_bits_equal(run_twin(cols, zeros, mr, False, torch.float64),
                      run_jax(cols, inp, mr, False, torch.float64),
                      torch.float64)


# ---------------------------------------------------------------------------
# the broker's family drain against the JAX broker's
# ---------------------------------------------------------------------------


def _fam_eval(pkg, i, fam="fam", priority=50):
    return pkg.mock.evaluation(
        id=f"ev-{fam}-{i:04d}", job_id=f"{fam}/dispatch-{i:04d}",
        priority=priority,
    )


def _broker(pkg, **kw):
    b = pkg.Broker(**kw)
    b.set_enabled(True)
    return b


def _stats(b):
    return (b.stats["total_ready"], b.stats["total_unacked"])


def script_children(pkg):
    mk = pkg.mock.evaluation
    base = mk(job_id="ingest", namespace="default")
    out = [pkg.job_family(base)]
    for jid, ns in (("ingest/dispatch-1723-abcd", "default"),
                    ("ingest/periodic-1723", "default"),
                    ("ingest", "prod"), ("other", "default")):
        out.append(pkg.job_family(mk(job_id=jid, namespace=ns)))
    hinted = mk(job_id="x")
    hinted.family_hint = "node-down:w1"
    out.append(pkg.job_family(hinted))
    return out


def script_no_leapfrog(pkg):
    b = _broker(pkg)
    front = [_fam_eval(pkg, i) for i in range(3)]
    stranger = pkg.mock.evaluation(id="ev-stranger", job_id="other-job")
    tail = [_fam_eval(pkg, i) for i in range(3, 5)]
    for ev in front + [stranger] + tail:
        b.enqueue(ev)
    out = [ev.id for ev, _t in
           b.drain_family(["service"], ("default", "fam"), max_n=10)]
    order = []
    for _ in range(3):
        ev, tok = b.dequeue(["service"], timeout=1)
        order.append(ev.id)
        b.ack(ev.id, tok)
    return out, order, _stats(b)


def script_max_n(pkg):
    b = _broker(pkg)
    for i in range(6):
        b.enqueue(_fam_eval(pkg, i))
    out = b.drain_family(["service"], ("default", "fam"), max_n=4)
    ev, tok = b.dequeue(["service"], timeout=1)
    b.nack(ev.id, tok)
    return [e.id for e, _t in out], ev.id, _stats(b)


def script_min_n(pkg):
    b = _broker(pkg)
    for i in range(2):
        b.enqueue(_fam_eval(pkg, i))
    out = b.drain_family(["service"], ("default", "fam"), max_n=10, min_n=3)
    before = _stats(b)
    order = []
    for _ in range(2):
        ev, tok = b.dequeue(["service"], timeout=1)
        order.append(ev.id)
        b.ack(ev.id, tok)
    return out, before, order


def script_priority_fence(pkg):
    b = _broker(pkg)
    for i in range(3):
        b.enqueue(_fam_eval(pkg, i))
    b.enqueue(pkg.mock.evaluation(id="ev-vip", job_id="vip", priority=90))
    out = b.drain_family(["service"], ("default", "fam"), max_n=10)
    ev, tok = b.dequeue(["service"], timeout=1)
    b.ack(ev.id, tok)
    return out, ev.id, _stats(b)


def script_tokens_and_nack(pkg):
    b = _broker(pkg, delivery_limit=5)
    for i in range(4):
        b.enqueue(_fam_eval(pkg, i))
    out = b.drain_family(["service"], ("default", "fam"), max_n=10)
    after = _stats(b)
    try:
        b.ack(out[0][0].id, "bogus-token")
        stale = "accepted"
    except ValueError:
        stale = "rejected"
    for ev, tok in out[:2]:
        b.ack(ev.id, tok)
    for ev, tok in out[2:]:
        b.nack(ev.id, tok)
    redelivered = []
    for _ in range(2):
        ev, tok = b.dequeue(["service"], timeout=1)
        redelivered.append(ev.id)
        b.ack(ev.id, tok)
    return [e.id for e, _t in out], after, stale, sorted(redelivered), _stats(b)


def script_nack_timeout(pkg):
    b = _broker(pkg, nack_timeout=0.1, delivery_limit=5)
    for i in range(2):
        b.enqueue(_fam_eval(pkg, i))
    out = b.drain_family(["service"], ("default", "fam"), max_n=10)
    got = set()
    for _ in range(2):
        ev, tok = b.dequeue(["service"], timeout=3)
        got.add(ev.id)
        b.ack(ev.id, tok)
    return sorted(e.id for e, _t in out), sorted(got), _stats(b)


BROKER_SCRIPTS = {
    "children_collapse": script_children,
    "no_leapfrog": script_no_leapfrog,
    "max_n": script_max_n,
    "all_or_nothing_below_min_n": script_min_n,
    "priority_fence": script_priority_fence,
    "tokens_and_nack": script_tokens_and_nack,
    "nack_timeout": script_nack_timeout,
}


@pytest.mark.parametrize("script", sorted(BROKER_SCRIPTS))
def test_broker_family_matches_jax(script):
    want = BROKER_SCRIPTS[script](JAX)
    got = BROKER_SCRIPTS[script](TORCH)
    assert got == want
    if script == "no_leapfrog":
        assert got[0] == ["ev-fam-0000", "ev-fam-0001", "ev-fam-0002"]
        assert got[1][0] == "ev-stranger"
    if script == "all_or_nothing_below_min_n":
        assert got[0] == [] and got[1] == (2, 0)
    if script == "priority_fence":
        assert got[0] == [] and got[1] == "ev-vip"


# ---------------------------------------------------------------------------
# the storm Server against the JAX storm Server
# ---------------------------------------------------------------------------


def make_nodes(pkg, n, seed=3):
    rng = random.Random(seed)
    nodes = []
    for i in range(n):
        node = pkg.mock.node(id=f"storm-node-{seed}-{i:04d}", name=f"n{i}")
        node.node_resources.cpu = rng.choice([8000, 16000])
        node.node_resources.memory_mb = rng.choice([16384, 32768])
        node.meta["pool"] = f"p{i % POOLS}"
        node.computed_class = pkg.structs.compute_node_class(node)
        nodes.append(node)
    return nodes


def family_jobs(pkg, n, fam="stfam", count=1, cpu=2000):
    jobs = []
    for i in range(n):
        job = pkg.mock.job(id=f"{fam}/dispatch-{i:04d}")
        job.type = "batch"
        job.task_groups[0].count = count
        job.task_groups[0].tasks[0].resources.cpu = cpu
        job.task_groups[0].tasks[0].resources.memory_mb = 4096
        jobs.append(job)
    return jobs


def gated_family(pkg):
    """A 20-member family with members the solver cannot take: static
    ports, a spread, a second task group; the rest are plain."""
    S = pkg.structs
    jobs = family_jobs(pkg, 20, fam="gfam", count=2, cpu=1000)
    for job in jobs[2:4]:
        job.task_groups[0].networks = [S.NetworkResource(
            mode="host", reserved_ports=[S.Port(label="http", value=8080)],
        )]
    for job in jobs[6:8]:
        job.spreads = [S.Spread(attribute="${node.datacenter}", weight=50)]
    tg0 = jobs[11].task_groups[0]
    jobs[11].task_groups.append(S.TaskGroup(
        name="side", count=1, restart_policy=tg0.restart_policy,
        reschedule_policy=tg0.reschedule_policy,
        tasks=[S.Task(name="side-task", driver="mock_driver",
                      resources=copy.deepcopy(tg0.tasks[0].resources))],
        ephemeral_disk=tg0.ephemeral_disk,
    ))
    return jobs


POOLS = 8


def node_down_jobs(pkg):
    """One service job per node pool (a `${meta.pool}` constraint), so
    every node hosts allocs of at most one job: the wave's replan evals
    then come in the order of the downed nodes, whatever order the
    store's per-node alloc sets iterate in."""
    jobs = []
    for i in range(POOLS):
        job = pkg.mock.job(id=f"svc-{i:02d}")
        job.task_groups[0].count = 3
        job.task_groups[0].tasks[0].resources.cpu = 1500
        job.constraints = list(job.constraints) + [pkg.structs.Constraint(
            ltarget="${meta.pool}", rtarget=f"p{i}", operand="=",
        )]
        jobs.append(job)
    return jobs


def wave_stage(server, pkg):
    """A node-down wave: in every pool the first node holding an alloc
    misses its heartbeat, all at once, so their replan evals carry one
    family hint."""
    held = {a.node_id for a in server.store.allocs.values()
            if not a.terminal_status()}
    ids = []
    for p in range(POOLS):
        pool = sorted(n.id for n in server.store.nodes.values()
                      if n.meta.get("pool") == f"p{p}")
        ids.append(next(n for n in pool if n in held))
    for node_id in ids:
        server._heartbeat_deadlines.pop(node_id, None)
    server._heartbeats_expired(ids)


SERVER_SCENARIOS = {
    # name: (n_nodes, nodes seed, jobs registered before start, stages)
    "dispatch_family": (24, 3, lambda p: family_jobs(p, 24), []),
    "gated_members": (24, 4, gated_family, []),
    "node_down_wave": (32, 5, node_down_jobs, [wave_stage]),
}
STORM_COUNTS = ("solves", "evals", "rows", "fallbacks", "divergent")


def keep_solves(monkeypatch, worker_cls, solves):
    """Record every storm solve of a worker class: the staged problem,
    the node columns the solve read (as numpy) and its six outputs."""
    orig = worker_cls._storm_solve

    def keep(self, problem, snap):
        out = orig(self, problem, snap)
        # copies: the mirror is patched in place by later syncs
        cols = tuple(np.array(c, copy=True)
                     for c in self._device_columns(snap.node_table))
        solves.append((problem, cols, out))
        return out

    monkeypatch.setattr(worker_cls, "_storm_solve", keep)


def run_storm_server(pkg, scenario, **kw):
    n_nodes, seed, make_jobs, stages = SERVER_SCENARIOS[scenario]
    server = pkg.Server(num_schedulers=1, seed=11, batch_pipeline=True,
                        heartbeat_ttl=1e9, **kw)
    jobs = make_jobs(pkg)
    try:
        for node in make_nodes(pkg, n_nodes, seed):
            server.register_node(copy.deepcopy(node))
        # registered before leadership: the family lands in the broker
        # as one restore wave, the mass-drain shape
        for job in jobs:
            server.register_job(copy.deepcopy(job))
        server.start()
        assert server.drain_to_idle(120)
        for stage in stages:
            stage(server, pkg)
            assert server.drain_to_idle(120)
        worker = server.workers[0]
        placements = sorted(
            (a.name, a.node_id) for a in server.store.allocs.values()
            if not a.terminal_status()
        )
        counts = {k: getattr(worker, f"storm_{k}") for k in STORM_COUNTS}
        counts["rounds"] = server.metrics.get_gauge("storm.rounds")
        for k in STORM_COUNTS:
            assert server.metrics.get_counter(f"storm.{k}") == counts[k]
        lost = [
            ev.id for job in jobs
            for ev in server.store.evals_by_job("default", job.id)
            if not ev.terminal_status()
        ] + [ev.id for ev in server.broker.failed()]
        return placements, counts, worker, lost
    finally:
        server.stop()


@pytest.mark.parametrize("scenario", sorted(SERVER_SCENARIOS))
def test_storm_server_matches_jax(monkeypatch, scenario):
    from nomad_tpu.server.batch_worker import BatchWorker as JaxWorker
    from nomad_tpu_torch.server.batch_worker import BatchWorker as TorchWorker

    monkeypatch.setenv("NOMAD_TPU_STORM", "1")
    monkeypatch.setenv("NOMAD_TPU_STORM_MIN", "8")
    jax_solves, solves = [], []
    keep_solves(monkeypatch, JaxWorker, jax_solves)
    keep_solves(monkeypatch, TorchWorker, solves)
    want, want_counts, _jw, jax_lost = run_storm_server(JAX, scenario)
    got, counts, worker, lost = run_storm_server(TORCH, scenario,
                                                 device="cpu")
    assert got == want
    assert counts == want_counts
    # the same staged problems, member for member and array for array
    assert len(solves) == len(jax_solves) == counts["solves"]
    for (problem, cols, out), (j_problem, j_cols, j_out) in zip(
        solves, jax_solves
    ):
        assert [(m.ev.job_id, m.reason, m.row0, m.row1)
                for m in problem.members] == [
            (m.ev.job_id, m.reason, m.row0, m.row1)
            for m in j_problem.members]
        for name in tsolve.StormInputs._fields:
            a, b = getattr(problem.inputs, name), getattr(j_problem.inputs,
                                                          name)
            assert (a is None) == (b is None), name
            if a is not None:
                np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)
        assert_bits_equal(list(out), list(j_out), torch.float64)
        # the JAX package's staging through the port's twin gives the
        # JAX solve's answer
        twin = tsolve.storm_assignment_twin(
            storm_inputs(j_problem.inputs, "cpu"),
            tuple(torch.from_numpy(c) for c in j_cols),
            j_problem.spread_fit, j_problem.max_rounds,
        )
        assert_bits_equal([x.numpy() for x in twin], list(j_out),
                          torch.float64)
    assert lost == [] and jax_lost == []
    assert worker.errors == 0
    assert counts["solves"] >= 1
    if scenario == "dispatch_family":
        assert counts["evals"] == 24 and counts["rows"] == 24
        assert len(got) == 24
        # the solve's wall time feeds its own EWMA bucket, never the
        # chunk-width buckets the adaptive gulp policy plans from
        assert list(worker._launch_ewma) == ["storm"]
        assert worker._launch_ewma_seed is None
    if scenario == "gated_members":
        # ports, spread and the two-group job are fallbacks
        assert counts["fallbacks"] >= 5
    if scenario == "node_down_wave":
        assert counts["evals"] >= 8


@pytest.mark.parametrize("mode", ["below_threshold", "off"])
def test_storm_below_threshold_and_off_are_inert(monkeypatch, mode):
    if mode == "off":
        monkeypatch.setenv("NOMAD_TPU_STORM", "0")
        monkeypatch.setenv("NOMAD_TPU_STORM_MIN", "1")
    else:
        monkeypatch.setenv("NOMAD_TPU_STORM", "1")
        monkeypatch.setenv("NOMAD_TPU_STORM_MIN", "64")
    server = TorchServer(num_schedulers=1, seed=11, batch_pipeline=True,
                         heartbeat_ttl=1e9, device="cpu")
    jobs = family_jobs(TORCH, 6 if mode == "below_threshold" else 10)
    try:
        for node in make_nodes(TORCH, 24):
            server.register_node(node)
        for job in jobs:
            server.register_job(job)
        server.start()
        assert server.drain_to_idle(60)
        worker = server.workers[0]
        assert worker.storm_enabled == (mode != "off")
        assert worker.storm_solves == 0 and worker.storm_evals == 0
        assert server.metrics.get_gauge("batch_worker.storm_enabled") == (
            0.0 if mode == "off" else 1.0
        )
        for job in jobs:
            placed = [a for a in server.store.allocs_by_job("default", job.id)
                      if not a.terminal_status()]
            assert len(placed) == 1
        assert worker.prescored == len(jobs) and worker.errors == 0
    finally:
        server.stop()


def test_storm_fault_stops_the_worker(monkeypatch):
    """A failing solve stops the batch worker with DeviceFault; the
    members' leases go back to the broker and nothing of the storm is
    placed by the host oracle."""
    from nomad_tpu_torch.server.batch_worker import DeviceFault

    monkeypatch.setenv("NOMAD_TPU_STORM", "1")
    monkeypatch.setenv("NOMAD_TPU_STORM_MIN", "4")

    def kernel_fault(*_args, **_kwargs):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr("nomad_tpu_torch.ops.solve.storm_assignment_twin",
                        kernel_fault)
    server = TorchServer(num_schedulers=1, seed=11, batch_pipeline=True,
                         heartbeat_ttl=1e9, device="cpu", nack_timeout=600)
    jobs = family_jobs(TORCH, 10, fam="failfam")
    try:
        for node in make_nodes(TORCH, 24):
            server.register_node(node)
        for job in jobs:
            server.register_job(job)
        server.start()
        with pytest.raises(DeviceFault) as info:
            server.drain_to_idle(60)
        worker = server.workers[0]
        assert isinstance(info.value.__cause__, RuntimeError)
        assert worker.fault is info.value
        worker._thread.join(5)
        assert not worker._thread.is_alive()
        assert worker.storm_evals == 10 and worker.storm_solves == 0
        assert worker.storm_fallbacks == 0
        assert worker.prescored == 0 and worker.errors == 1
        assert server.store.allocs_by_job("default", jobs[0].id) == []
        assert not any(a for a in server.store.allocs.values())
        # every lease is back: nothing unacked, all ten evals ready
        assert server.broker.stats["total_unacked"] == 0
        assert server.broker.stats["total_ready"] == 10
    finally:
        server.stop()


def test_weighted_storm_raises(monkeypatch):
    """A family one of whose jobs resolves a policy is a weighted solve
    (policy rows staged for that member, zero rows for the rest): the
    port's storm Server places it as the JAX storm Server does, the
    staged problems and the solves' outputs equal."""
    from nomad_tpu.server.batch_worker import BatchWorker as JaxWorker
    from nomad_tpu_torch.server.batch_worker import BatchWorker as TorchWorker

    monkeypatch.setenv("NOMAD_TPU_STORM", "1")
    monkeypatch.setenv("NOMAD_TPU_STORM_MIN", "4")
    jax_solves, solves = [], []
    keep_solves(monkeypatch, JaxWorker, jax_solves)
    keep_solves(monkeypatch, TorchWorker, solves)

    def run(pkg, **kw):
        server = pkg.Server(num_schedulers=1, seed=11, batch_pipeline=True,
                            heartbeat_ttl=1e9, **kw)
        jobs = family_jobs(pkg, 6, fam="polfam")
        jobs[2].policy = pkg.structs.PolicySpec(
            throughput={"gpu-a": 2.0, "gpu-b": 1.0},
            throughput_coefficient=0.5,
        )
        try:
            for i, node in enumerate(make_nodes(pkg, 24)):
                node.node_class = "gpu-a" if i % 2 else "gpu-b"
                node.computed_class = pkg.structs.compute_node_class(node)
                server.register_node(node)
            for job in jobs:
                server.register_job(job)
            server.start()
            assert server.drain_to_idle(60)
            worker = server.workers[0]
            placements = sorted(
                (a.name, a.node_id) for a in server.store.allocs.values()
                if not a.terminal_status()
            )
            counts = {k: getattr(worker, f"storm_{k}") for k in STORM_COUNTS}
            return (placements, counts, worker.errors,
                    server.metrics.get_counter("policy.storm_evals"))
        finally:
            server.stop()

    want = run(JAX)
    got = run(TORCH, device="cpu")
    assert got == want
    assert len(got[0]) == 6 and got[2] == 0
    assert got[1]["solves"] == 1 and got[1]["evals"] == 6
    assert got[3] == 1
    (problem, _cols, out), (j_problem, _jc, j_out) = solves[0], jax_solves[0]
    for name in tsolve.StormInputs._fields:
        a, b = getattr(problem.inputs, name), getattr(j_problem.inputs, name)
        assert a is not None, name
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)
    assert_bits_equal(list(out), list(j_out), torch.float64)
