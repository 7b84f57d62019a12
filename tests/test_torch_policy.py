"""Port parity: policy-weighted scoring (a job carrying a `PolicySpec`).

The cases of `tests/test_policy.py` (all but the node-sharded solve and
the fan-out follower, which the port does not have) run through the
JAX package and the port on one world:

- per-eval selects three ways: the JAX package's ServiceScheduler on its
  device stack (``use_tpu=True``), the port's on ``device="cpu"`` (the
  CUDA stack with the plain twins) and the port's host oracle chain
  (``use_device=False``); placements and every scored node's
  `NodeScoreMeta` (the `policy.throughput` / `policy.migration`
  components included) must be identical;
- the policy branch of K1's twin against the JAX
  `score_and_select_packed`, and of K5's twin against the JAX
  `storm_assignment` (all six outputs), on the seeded policy cases of
  `ops/cases.py`, f64 and f32, bit for bit;
- a preemption-mode select of a weighted job (numpy scores, K6's twin);
- the batched `Server(device="cpu")` with the storm on and a family
  whose members carry policies, against the JAX `Server`;
- the `policy.*` metric family of a fresh Server and after a weighted
  select and a weighted storm.
"""
import copy
import dataclasses
import random
import types

import numpy as np
import pytest
import torch

import nomad_tpu.mock as jmock
import nomad_tpu.structs as jstructs
import nomad_tpu_torch.mock as tmock
import nomad_tpu_torch.structs as tstructs
from nomad_tpu.api.codec import eval_to_dict
from nomad_tpu.ops import score as jscore
from nomad_tpu.ops import solve as jsolve
from nomad_tpu.sched import generic_sched as jgs
from nomad_tpu.sched import policy as jpolicy
from nomad_tpu.sched.testing import Harness as JHarness
from nomad_tpu.server import Server as JaxServer
from nomad_tpu_torch.ops import score as tscore
from nomad_tpu_torch.ops import solve as tsolve
from nomad_tpu_torch.ops.cases import (
    INT32_MAX,
    POLICY_SCORE_SCENARIOS,
    POLICY_STORM_SCENARIOS,
    policy_score_case,
    policy_storm_case,
)
from nomad_tpu_torch.sched import generic_sched as tgs
from nomad_tpu_torch.sched import policy as tpolicy
from nomad_tpu_torch.server import Server as TorchServer
from nomad_tpu_torch.state.convert import (
    dataclass_from_dict,
    score_inputs_from_numpy,
    storm_columns,
    storm_inputs,
)

from test_torch_preempt import (
    assert_three_way as preempt_three_way,
    enable_preemption,
    high_job,
    mixed_fleet,
    submit,
)
from test_torch_sched import carry

JAX = types.SimpleNamespace(mock=jmock, structs=jstructs, Server=JaxServer,
                            policy=jpolicy)
TORCH = types.SimpleNamespace(mock=tmock, structs=tstructs,
                              Server=TorchServer, policy=tpolicy)

TPUT_TABLE = {"fast": 2.0, "slow": 1.0}
NP_DTYPE = {torch.float64: np.float64, torch.float32: np.float32}
COLS = ("cpu_total", "mem_total", "disk_total", "cpu_used", "mem_used",
        "disk_used")


@pytest.fixture(autouse=True)
def _fresh_tput_caches():
    """Each package keeps its own throughput-tensor cache; start every
    test from empty ones so cache counters compare."""
    jpolicy.clear_tput_cache()
    tpolicy.clear_tput_cache()
    yield


# ---------------------------------------------------------------------------
# per-eval selects: JAX device stack, port CUDA stack (twins), port oracle
# ---------------------------------------------------------------------------


def policy_cluster(h, n_nodes, seed=0, prefix="pol"):
    """test_policy.py's mixed-class cluster (every third node 'fast'),
    with explicit node ids."""
    rng = random.Random(seed)
    nodes = []
    for i in range(n_nodes):
        n = jmock.node(id=f"{prefix}-{seed}-{i:03d}")
        n.node_class = "fast" if i % 3 == 0 else "slow"
        n.node_resources.cpu = rng.choice([4000, 8000])
        n.node_resources.memory_mb = rng.choice([8192, 16384])
        n.attributes["rack"] = f"r{rng.randint(0, 4)}"
        n.computed_class = jstructs.compute_node_class(n)
        h.store.upsert_node(n)
        nodes.append(n)
    return nodes


def policy_job(tput=None, mig=0.0, count=6, cpu=500, mem=512, **kw):
    job = jmock.job(**kw)
    job.task_groups[0].count = count
    job.task_groups[0].tasks[0].resources.cpu = cpu
    job.task_groups[0].tasks[0].resources.memory_mb = mem
    job.policy = jstructs.PolicySpec(
        throughput=dict(tput or {}), migration_coefficient=mig
    )
    return job


def plan_view(h):
    """Placements and every placed alloc's scored nodes (id, component
    scores, normalized score) of the harness's last plan."""
    allocs = [a for v in h.plans[-1].node_allocation.values() for a in v]
    placed = sorted((a.name, a.node_id) for a in allocs)
    meta = {
        a.name: sorted(
            (m.node_id, tuple(sorted(m.scores.items())), m.norm_score)
            for m in a.metrics.score_meta
        )
        for a in allocs
    }
    return placed, meta


def three_way(jh, ev, seed):
    """The eval through the JAX device stack, the port's device stack on
    the CPU and the port's oracle chain, each on the same unmutated
    world.  Returns the three plan views."""
    th = carry(jh)
    oh = carry(jh)
    for h in (jh, th, oh):
        h.reject_plan = True
    jh.process(jgs.ServiceScheduler, ev, use_tpu=True, seed=seed)
    tev = dataclass_from_dict(tstructs.Evaluation, eval_to_dict(ev))
    th.process(tgs.ServiceScheduler, tev, device="cpu", seed=seed)
    oh.process(tgs.ServiceScheduler, tev, use_device=False, seed=seed)
    return plan_view(jh), plan_view(th), plan_view(oh)


def assert_three_way(jh, ev, seed):
    j, t, o = three_way(jh, ev, seed)
    assert t[0] == j[0], f"placements: jax={j[0]} port={t[0]}"
    assert t[0] == o[0], f"placements: oracle={o[0]} port={t[0]}"
    assert t[1] == j[1], "score_meta differs from the JAX device stack"
    assert t[1] == o[1], "score_meta differs from the port's host oracle"
    return t


@pytest.mark.parametrize("trial", range(4))
def test_throughput_weighted_parity(trial):
    jh = JHarness()
    nodes = policy_cluster(jh, 36, seed=trial)
    job = policy_job(tput=TPUT_TABLE, id=f"tput-{trial}")
    jh.store.upsert_job(job)
    placed, meta = assert_three_way(
        jh, jmock.evaluation(job_id=job.id), seed=trial * 7 + 1
    )
    assert len(placed) == 6
    class_of = {n.id: n.node_class for n in nodes}
    assert all(class_of[node_id] == "fast" for _, node_id in placed)
    for rows in meta.values():
        # the weighted walk is unlimited: every candidate is scored
        assert len(rows) >= 12
        assert all("policy.throughput" in dict(s) for _n, s, _v in rows)


@pytest.mark.parametrize("trial", range(3))
def test_policy_with_affinity_and_spread_parity(trial):
    jh = JHarness()
    policy_cluster(jh, 30, seed=trial + 50)
    job = policy_job(tput=TPUT_TABLE, mig=0.25, count=8, id=f"aff-{trial}")
    job.affinities = [jstructs.Affinity("${attr.rack}", "r1", "=", 40)]
    job.spreads = [
        jstructs.Spread(
            attribute="${attr.rack}",
            weight=30,
            targets=(jstructs.SpreadTarget("r0", 60),
                     jstructs.SpreadTarget("r2", 40)),
        )
    ]
    jh.store.upsert_job(job)
    placed, _ = assert_three_way(
        jh, jmock.evaluation(job_id=job.id), seed=trial * 5 + 2
    )
    assert len(placed) == 8


def test_migration_penalty_holds_incumbents_and_stays_parity():
    """A destructive update (env bump) of a placed job: the migration
    term keeps every replacement on its incumbent node, the same way in
    both packages, `policy.migration` recorded on every scored node."""
    jh = JHarness()
    policy_cluster(jh, 24, seed=9)
    job = policy_job(mig=0.5, count=6, id="mig")
    job.task_groups[0].tasks[0].env = {"V": "1"}
    jh.store.upsert_job(job)
    jh.process(jgs.ServiceScheduler, jmock.evaluation(job_id=job.id),
               use_tpu=True, seed=3)
    incumbents = sorted(
        a.node_id for a in jh.store.allocs_by_job("default", job.id)
        if not a.terminal_status()
    )
    assert len(incumbents) == 6
    job2 = copy.deepcopy(job)
    job2.task_groups[0].tasks[0].env = {"V": "2"}  # destructive
    jh.store.upsert_job(job2)
    placed, meta = assert_three_way(
        jh, jmock.evaluation(job_id=job.id), seed=4
    )
    assert sorted(n for _, n in placed) == incumbents
    for rows in meta.values():
        scores = [dict(s) for _n, s, _v in rows]
        assert all("policy.migration" in s for s in scores)
        assert any(s["policy.migration"] == -0.5 for s in scores)


def test_migration_zero_runtime_cutoff_fresh_placement():
    """min_runtime_s in the future: no alloc is sticky yet, the migration
    group stays inert (None) and `policy.migration` records 0."""
    jh = JHarness()
    policy_cluster(jh, 18, seed=11)
    job = policy_job(tput=TPUT_TABLE, mig=0.5, count=4, id="cutoff")
    job.policy.min_runtime_s = 3600.0
    jh.store.upsert_job(job)
    placed, meta = assert_three_way(jh, jmock.evaluation(job_id=job.id),
                                    seed=5)
    assert len(placed) == 4
    for rows in meta.values():
        assert all(dict(s)["policy.migration"] == 0 for _n, s, _v in rows)


def test_policy_off_knob_matches_specless_job(monkeypatch):
    """NOMAD_TPU_POLICY=0 with a spec'd job places exactly like the same
    job without a spec, in both packages, with no policy component."""
    jh = JHarness()
    policy_cluster(jh, 30, seed=21)
    spec_job = policy_job(tput=TPUT_TABLE, mig=0.5, id="knob-a")
    bare_job = policy_job(tput=TPUT_TABLE, id="knob-b")
    bare_job.policy = None
    jh.store.upsert_job(spec_job)
    jh.store.upsert_job(bare_job)
    monkeypatch.setenv("NOMAD_TPU_POLICY", "0")
    off, off_meta = assert_three_way(
        jh, jmock.evaluation(job_id=spec_job.id), seed=6
    )
    monkeypatch.delenv("NOMAD_TPU_POLICY")
    bare, _ = assert_three_way(
        jh, jmock.evaluation(job_id=bare_job.id), seed=6
    )
    assert sorted(n for _, n in off) == sorted(n for _, n in bare)
    for rows in off_meta.values():
        for _n, scores, _v in rows:
            assert not any(k.startswith("policy.") for k, _ in scores)


def test_resolve_knob_overrides(monkeypatch):
    def both(job):
        tjob = dataclass_from_dict(tstructs.Job, dataclasses.asdict(job))
        return jpolicy.resolve(job), tpolicy.resolve(tjob)

    job = policy_job(tput=TPUT_TABLE, mig=0.5)
    j, t = both(job)
    assert tuple(t) == tuple(j)
    assert t.tput_coef == 1.0 and t.mig_coef == 0.5
    assert (t.tput_value("fast"), t.tput_value("slow"),
            t.tput_value("unknown")) == (1.0, 0.5, 0.0)
    monkeypatch.setenv("NOMAD_TPU_POLICY_TPUT_COEF", "2.5")
    monkeypatch.setenv("NOMAD_TPU_POLICY_MIG_COEF", "0.75")
    j, t = both(job)
    assert tuple(t) == tuple(j)
    assert t.tput_coef == 2.5 and t.mig_coef == 0.75
    monkeypatch.setenv("NOMAD_TPU_POLICY", "0")
    assert both(job) == (None, None)


def test_preempt_select_of_a_weighted_job(monkeypatch):
    """A priority-80 weighted job on a full mixed fleet: the preemption
    select's numpy scores carry the policy terms (and the walk is
    unlimited); placements, preemption sets and every AllocMetric field
    equal the JAX package's, placements and preemption sets the port
    oracle's."""
    jh = JHarness()
    mixed_fleet(jh)
    for i, node in enumerate(sorted(jh.store.nodes.values(),
                                    key=lambda n: n.id)):
        node = copy.deepcopy(node)
        node.node_class = "fast" if i % 3 == 0 else "slow"
        node.computed_class = jstructs.compute_node_class(node)
        jh.store.upsert_node(node)
    enable_preemption(jh)
    job = high_job(jh, "high-pol", 6)
    job.policy = jstructs.PolicySpec(throughput=dict(TPUT_TABLE),
                                     migration_coefficient=0.5)
    t, spy = preempt_three_way(jh, submit(jh, job), 9, monkeypatch)
    assert len(t[0]) == 6
    assert spy.selects >= 1
    metrics = list(t[2].values())
    assert any(
        "policy.throughput" in m_["scores"]
        for m in metrics for m_ in m["score_meta"]
    )


# ---------------------------------------------------------------------------
# K1's and K5's policy branches: the twins against the JAX programs
# ---------------------------------------------------------------------------


def jax_score_inputs(case, f):
    pol = case["policy"]
    policy = None if pol is None else jscore.PolicyTerms(
        tput_term=None if pol["tput_term"] is None
        else pol["tput_term"].astype(f),
        has_tput=None if pol["has_tput"] is None
        else np.asarray(pol["has_tput"], f),
        mig_term=None if pol["mig_term"] is None
        else pol["mig_term"].astype(f),
    )
    cols = {k: case[k].astype(f) for k in COLS + ("affinity_score",
                                                  "spread_boost")}
    return jscore.ScoreInputs(
        **cols, feasible=case["feasible"], collisions=case["collisions"],
        penalty=case["penalty"], perm=case["perm"],
        ask_cpu=f(case["ask_cpu"]), ask_mem=f(case["ask_mem"]),
        ask_disk=f(case["ask_disk"]),
        desired_count=np.int32(case["desired_count"]),
        limit=np.int32(case["limit"]),
        n_candidates=np.int32(case["n_candidates"]), policy=policy,
    )


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int64 if x.dtype == np.float64 else np.int32)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("limit", [2, 14, INT32_MAX])
@pytest.mark.parametrize("scenario", sorted(POLICY_SCORE_SCENARIOS))
def test_k1_policy_twin_matches_jax(scenario, limit, dtype):
    seed = 1300 + sorted(POLICY_SCORE_SCENARIOS).index(scenario)
    case = policy_score_case(seed, 256, 200, scenario, limit)
    jin = jax_score_inputs(case, NP_DTYPE[dtype])
    tin = score_inputs_from_numpy(case, "cpu", dtype=dtype)
    assert (tin.policy is None) == (scenario == "inert")
    packed = np.asarray(jscore.score_and_select_packed(jin))
    got = tscore.score_and_select_packed(tin).numpy()
    np.testing.assert_array_equal(got, packed)
    j_row, j_best, j_n, j_pulls = jscore.score_and_select(jin)
    t_row, t_best, t_n, t_pulls = tscore.score_and_select(tin)
    assert int(t_row) == int(j_row) and int(t_pulls) == int(j_pulls)
    assert int(t_n) == int(j_n)
    assert _bits(t_best.numpy()) == _bits(np.asarray(j_best))
    _jf, j_scores = jscore.score_all(jin)
    _tf, t_scores = tscore.score_all(tin)
    np.testing.assert_array_equal(_bits(t_scores.numpy()), _bits(j_scores))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("scenario", sorted(POLICY_STORM_SCENARIOS))
def test_k5_policy_twin_matches_jax(scenario, dtype):
    f = NP_DTYPE[dtype]
    seed = 1400 + sorted(POLICY_STORM_SCENARIOS).index(scenario)
    cols, inp, max_rounds = policy_storm_case(seed, 4, 32, 128, scenario)
    jin = jsolve.StormInputs(**{
        k: v.astype(f) if v.dtype.kind == "f" else v for k, v in inp.items()
    })
    want = [np.asarray(x) for x in jsolve.storm_assignment(
        jin, tuple(cols[k].astype(f) for k in COLS), spread_fit=False,
        max_rounds=max_rounds,
    )]
    out = tsolve.storm_assignment(
        storm_inputs(inp, "cpu", dtype), storm_columns(cols, "cpu", dtype),
        False, max_rounds,
    )
    got = [x.numpy() for x in out]
    for name, g, w in zip(tsolve.StormOut._fields, got, want):
        if name == "score":
            np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    # the weights moved the answer: the unweighted solve differs
    unweighted = tsolve.storm_assignment(
        storm_inputs({k: v for k, v in inp.items()
                      if not k.startswith("policy_")}, "cpu", dtype),
        storm_columns(cols, "cpu", dtype), False, max_rounds,
    )
    assert not torch.equal(unweighted.score, out.score)


def test_policy_inputs_are_checked():
    """A malformed policy is refused by the wrappers, on the CPU too."""
    case = policy_score_case(3, 64, 48, "both", INT32_MAX)
    inp = score_inputs_from_numpy(case, "cpu")
    with pytest.raises(ValueError):
        tscore.score_and_select(inp._replace(policy=inp.policy._replace(
            mig_term=inp.policy.mig_term[:10])))
    with pytest.raises(TypeError):
        tscore.score_and_select(inp._replace(policy=inp.policy._replace(
            tput_term=inp.policy.tput_term.float())))
    with pytest.raises(ValueError):
        tscore.score_and_select(inp._replace(policy=inp.policy._replace(
            has_tput=None)))
    cols, sinp, mr = policy_storm_case(4, 4, 8, 64, "mixed")
    t = storm_inputs(sinp, "cpu")
    with pytest.raises(ValueError):
        tsolve.storm_assignment(t._replace(policy_has_tput=None),
                                storm_columns(cols, "cpu"), False, mr)
    with pytest.raises(ValueError):
        tsolve.storm_assignment(
            t._replace(policy_mig_term=t.policy_mig_term[:2]),
            storm_columns(cols, "cpu"), False, mr)


# ---------------------------------------------------------------------------
# the weighted storm through the batched Server
# ---------------------------------------------------------------------------


def storm_nodes(pkg, n, seed=3):
    rng = random.Random(seed)
    nodes = []
    for i in range(n):
        node = pkg.mock.node(id=f"pol-storm-node-{seed}-{i:04d}",
                             name=f"n{i}")
        node.node_class = "fast" if i % 3 == 0 else "slow"
        node.node_resources.cpu = rng.choice([8000, 16000])
        node.node_resources.memory_mb = rng.choice([16384, 32768])
        node.computed_class = pkg.structs.compute_node_class(node)
        nodes.append(node)
    return nodes


def storm_policy_jobs(pkg, n, fam="polfam", weighted=lambda i: True):
    jobs = []
    for i in range(n):
        job = pkg.mock.job(id=f"{fam}/dispatch-{i:04d}")
        job.type = "batch"
        job.task_groups[0].count = 1
        job.task_groups[0].tasks[0].resources.cpu = 2000
        job.task_groups[0].tasks[0].resources.memory_mb = 4096
        if weighted(i):
            job.policy = pkg.structs.PolicySpec(throughput=dict(TPUT_TABLE))
        jobs.append(job)
    return jobs


def run_storm(pkg, jobs, n_nodes=18, **kw):
    """The family through a fresh batched Server (registered before
    start: one restore wave).  Returns placements by job, eval outcomes,
    the worker's storm counters and the policy.* counters."""
    server = pkg.Server(num_schedulers=1, seed=11, batch_pipeline=True,
                        heartbeat_ttl=1e9, **kw)
    try:
        for node in storm_nodes(pkg, n_nodes):
            server.register_node(node)
        for job in jobs:
            server.register_job(copy.deepcopy(job))
        server.start()
        assert server.drain_to_idle(120)
        worker = server.workers[0]
        placements = {
            job.id: sorted(
                (a.name, a.node_id)
                for a in server.store.allocs_by_job("default", job.id)
                if not a.terminal_status()
            )
            for job in jobs
        }
        outcomes = sorted(
            (e.job_id, e.status, e.status_description,
             tuple(sorted(e.queued_allocations.items())))
            for job in jobs
            for e in server.store.evals_by_job("default", job.id)
        )
        counts = {k: getattr(worker, f"storm_{k}") for k in (
            "solves", "evals", "rows", "fallbacks", "divergent")}
        dump = server.metrics.dump()
        policy = {k: v for k, v in dump["counters"].items()
                  if k.startswith("policy.")}
        return placements, outcomes, counts, policy, worker.errors
    finally:
        server.stop()


def test_one_row_weighted_storm_parity(monkeypatch):
    """One weighted eval forced through the storm solver (threshold 1,
    strict replay) places as the JAX storm Server and as the port's
    storm-off Server."""
    monkeypatch.setenv("NOMAD_TPU_REPLAY_STRICT", "1")
    monkeypatch.setenv("NOMAD_TPU_STORM", "1")
    monkeypatch.setenv("NOMAD_TPU_STORM_MIN", "1")
    want = run_storm(JAX, storm_policy_jobs(JAX, 1, fam="poldegen"))
    got = run_storm(TORCH, storm_policy_jobs(TORCH, 1, fam="poldegen"),
                    device="cpu")
    assert got == want
    assert got[2]["solves"] == 1 and got[2]["fallbacks"] == 0
    assert got[3]["policy.storm_evals"] == 1
    monkeypatch.setenv("NOMAD_TPU_STORM", "0")
    off = run_storm(TORCH, storm_policy_jobs(TORCH, 1, fam="poldegen"),
                    device="cpu")
    assert off[0] == got[0] and off[1] == got[1]
    assert off[2]["solves"] == 0 and off[4] == 0


def test_mass_weighted_storm_places_on_fast_class(monkeypatch):
    monkeypatch.setenv("NOMAD_TPU_STORM", "1")
    monkeypatch.setenv("NOMAD_TPU_STORM_MIN", "6")
    want = run_storm(JAX, storm_policy_jobs(JAX, 12, fam="polmass"),
                     n_nodes=24)
    got = run_storm(TORCH, storm_policy_jobs(TORCH, 12, fam="polmass"),
                    n_nodes=24, device="cpu")
    assert got == want
    assert got[2]["evals"] == 12 and got[4] == 0
    class_of = {n.id: n.node_class for n in storm_nodes(TORCH, 24)}
    placed = [p for v in got[0].values() for p in v]
    assert len(placed) == 12
    assert all(class_of[node_id] == "fast" for _, node_id in placed)


def test_mixed_family_storm_matches_jax(monkeypatch):
    """A family with weighted and policy-less members (and one with a
    migration coefficient only, inert on a fresh placement): one mixed
    solve, equal to the JAX Server's."""
    monkeypatch.setenv("NOMAD_TPU_STORM", "1")
    monkeypatch.setenv("NOMAD_TPU_STORM_MIN", "4")

    def family(pkg):
        jobs = storm_policy_jobs(pkg, 10, fam="mixfam",
                                 weighted=lambda i: i % 3 == 1)
        jobs[5].policy = pkg.structs.PolicySpec(migration_coefficient=0.5)
        return jobs

    want = run_storm(JAX, family(JAX), n_nodes=24)
    got = run_storm(TORCH, family(TORCH), n_nodes=24, device="cpu")
    assert got == want
    assert got[2]["solves"] >= 1 and got[2]["evals"] == 10
    assert got[3]["policy.storm_evals"] == 4 and got[4] == 0


# ---------------------------------------------------------------------------
# the policy.* metric family
# ---------------------------------------------------------------------------


def policy_series(server):
    dump = server.metrics.dump()
    return (
        {k: v for k, v in dump["counters"].items() if k.startswith("policy.")},
        {k: v for k, v in dump["gauges"].items() if k.startswith("policy.")},
    )


@pytest.mark.parametrize("batch_pipeline", [False, True])
def test_fresh_server_zero_registers_policy_series(batch_pipeline):
    servers = [
        JaxServer(num_schedulers=1, seed=1, batch_pipeline=batch_pipeline,
                  heartbeat_ttl=1e9),
        TorchServer(num_schedulers=1, seed=1, batch_pipeline=batch_pipeline,
                    heartbeat_ttl=1e9, device="cpu"),
    ]
    try:
        want, got = (policy_series(s) for s in servers)
        assert got == want
        assert set(got[0]) == set(tpolicy.POLICY_COUNTERS)
        assert set(got[1]) == set(tpolicy.POLICY_GAUGES)
        assert all(v == 0 for v in got[0].values())
    finally:
        for s in servers:
            s.stop()


def test_policy_counts_after_weighted_select_and_storm(monkeypatch):
    """A weighted service job (the per-eval path) and a weighted storm
    move the same policy.* series by the same counts in both Servers."""
    monkeypatch.setenv("NOMAD_TPU_STORM", "1")
    monkeypatch.setenv("NOMAD_TPU_STORM_MIN", "4")

    def run(pkg, **kw):
        server = pkg.Server(num_schedulers=1, seed=5, batch_pipeline=True,
                            heartbeat_ttl=1e9, **kw)
        try:
            for node in storm_nodes(pkg, 18, seed=7):
                server.register_node(node)
            for job in storm_policy_jobs(pkg, 6, fam="cntfam"):
                server.register_job(job)
            server.start()
            assert server.drain_to_idle(120)
            svc = pkg.mock.job(id="weighted-svc")
            svc.task_groups[0].count = 3
            svc.policy = pkg.structs.PolicySpec(
                throughput=dict(TPUT_TABLE), migration_coefficient=0.25)
            server.register_job(svc)
            assert server.drain_to_idle(120)
            placed = sorted((a.name, a.node_id)
                            for a in server.store.allocs.values()
                            if not a.terminal_status())
            return placed, policy_series(server), server.workers[0].errors
        finally:
            server.stop()

    want = run(JAX)
    got = run(TORCH, device="cpu")
    assert got == want
    counters, gauges = got[1]
    assert counters["policy.storm_evals"] == 6
    assert counters["policy.evals"] >= 1
    assert counters["policy.assemblies"] >= 1
    assert gauges["policy.cache_size"] >= 1
    assert got[2] == 0
