"""The port stands alone: a small schedule, a batched Server drain, a
storm solve, a preemption-mode select (K6's twin, the explain capture
and ring), a bridge ScoreBatch over the wire (K7's twin), a device
supervisor's flaky round trip (K8's twin, the hold, the preflight) and
a weighted select and weighted storm (K1's and K5's policy branches)
and the entry module's dryrun (the sharded select and batched planner)
through it, in a fresh interpreter, load neither `jax` nor anything of
`nomad_tpu`; and no module of the port imports either."""
import ast
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "nomad_tpu_torch"

SCRIPT = r"""
import sys
from nomad_tpu_torch import mock
from nomad_tpu_torch.sched import new_scheduler
from nomad_tpu_torch.sched.testing import Harness
from nomad_tpu_torch.structs import compute_node_class

h = Harness()
for i in range(12):
    n = mock.node(id=f"nj-{i:02d}")
    n.computed_class = compute_node_class(n)
    h.store.upsert_node(n)
job = mock.job(id="nj")
job.task_groups[0].count = 4
h.store.upsert_job(job)
ev = mock.evaluation(job_id=job.id)
new_scheduler("service", h.snapshot(), h, device="cpu", seed=1).process(ev)
placed = sum(len(v) for v in h.plans[-1].node_allocation.values())
bad = sorted(
    m for m in sys.modules
    if m == "jax" or m.startswith("jax.") or m == "jaxlib"
    or m == "nomad_tpu" or m.startswith("nomad_tpu.")
)
print(placed, bad)
"""


SERVER_SCRIPT = r"""
import sys
from nomad_tpu_torch import mock
from nomad_tpu_torch.server import Server

server = Server(batch_pipeline=True, device="cpu", seed=1,
                heartbeat_ttl=1e9)
server.start()
for i in range(12):
    server.register_node(mock.node(id=f"nj-{i:02d}"))
for k in range(3):
    job = mock.job(id=f"nj-{k}")
    job.task_groups[0].count = 4
    server.register_job(job)
assert server.drain_to_idle(60)
placed = sum(
    1 for a in server.store.allocs.values() if not a.terminal_status()
)
prescored = server.workers[0].prescored
server.stop()
bad = sorted(
    m for m in sys.modules
    if m == "jax" or m.startswith("jax.") or m == "jaxlib"
    or m == "nomad_tpu" or m.startswith("nomad_tpu.")
)
print(placed, prescored > 0, bad)
"""


STORM_SCRIPT = r"""
import os, sys
os.environ["NOMAD_TPU_STORM"] = "1"
os.environ["NOMAD_TPU_STORM_MIN"] = "4"
from nomad_tpu_torch import mock
from nomad_tpu_torch.server import Server

server = Server(batch_pipeline=True, device="cpu", seed=1,
                heartbeat_ttl=1e9)
for i in range(12):
    server.register_node(mock.node(id=f"nj-{i:02d}"))
for k in range(6):
    job = mock.job(id=f"nj/dispatch-{k}")
    job.task_groups[0].count = 1
    server.register_job(job)
server.start()
assert server.drain_to_idle(60)
placed = sum(
    1 for a in server.store.allocs.values() if not a.terminal_status()
)
solves = server.workers[0].storm_solves
server.stop()
bad = sorted(
    m for m in sys.modules
    if m == "jax" or m.startswith("jax.") or m == "jaxlib"
    or m == "nomad_tpu" or m.startswith("nomad_tpu.")
)
print(placed, solves, bad)
"""


PREEMPT_SCRIPT = r"""
import sys
from nomad_tpu_torch import mock
from nomad_tpu_torch.explain import EXPLAIN
from nomad_tpu_torch.server import Server

server = Server(batch_pipeline=False, device="cpu", seed=1,
                heartbeat_ttl=1e9)
cfg = server.store.get_scheduler_config()
cfg.tpu_scheduler_enabled = True
cfg.preemption_config.service_scheduler_enabled = True
server.store.set_scheduler_config(cfg)
server.start()
for i in range(4):
    node = mock.node(id=f"nj-{i:02d}")
    node.node_resources.cpu = 2000
    server.register_node(node)
low = mock.job(id="nj-low")
low.priority = 20
low.task_groups[0].count = 4
low.task_groups[0].tasks[0].resources.cpu = 1500
server.register_job(low)
assert server.drain_to_idle(60)
high = mock.job(id="nj-high")
high.priority = 80
high.task_groups[0].count = 1
high.task_groups[0].tasks[0].resources.cpu = 1200
ev = server.register_job(high)
assert server.drain_to_idle(60)
evicted = sum(
    1 for a in server.store.allocs.values() if a.desired_status == "evict"
)
explained = EXPLAIN.get(ev.id) is not None
errors = server.workers[0].errors
server.stop()
bad = sorted(
    m for m in sys.modules
    if m == "jax" or m.startswith("jax.") or m == "jaxlib"
    or m == "nomad_tpu" or m.startswith("nomad_tpu.")
)
print(evicted, explained, errors, bad)
"""


BRIDGE_SCRIPT = r"""
import socket, sys
from nomad_tpu_torch import mock, wire
from nomad_tpu_torch.server import Server
from nomad_tpu_torch.server.bridge_service import BridgeService

server = Server(device="cpu", num_schedulers=0, heartbeat_ttl=1e9)
server.start()
for i in range(12):
    server.register_node(mock.node(id=f"nj-{i:02d}"))
service = BridgeService(server, port=0)
service.start()
sock = socket.create_connection(("127.0.0.1", service.port))
resp = wire.call(sock, "TPUScheduler.ScoreBatch", {"evals": [
    {"eval_id": "e1", "seed": 7, "count": 3, "cpu": 500, "memory_mb": 256},
    {"eval_id": "e2", "seed": 8, "count": 2, "cpu": 200, "memory_mb": 128},
]})
sock.close()
service.stop()
server.stop()
placed = [len(r["nodes"]) for r in resp["results"]]
bad = sorted(
    m for m in sys.modules
    if m == "jax" or m.startswith("jax.") or m == "jaxlib"
    or m == "nomad_tpu" or m.startswith("nomad_tpu.")
)
print(placed, bad)
"""


DEVICE_SCRIPT = r"""
import os, sys
os.environ["NOMAD_TPU_FAULT"] = "flaky:3"
os.environ["NOMAD_TPU_PROBE_INTERVAL_S"] = "3600"
from nomad_tpu_torch import mock
from nomad_tpu_torch.device import preflight
from nomad_tpu_torch.server import Server

server = Server(batch_pipeline=True, device="cpu", seed=1,
                heartbeat_ttl=1e9)
server.start()
sup = server.device_supervisor
for i in range(12):
    server.register_node(mock.node(id=f"nj-{i:02d}"))
for _ in range(3):
    sup.probe_once()
lost = sup.state()
job = mock.job(id="nj-held")
job.task_groups[0].count = 4
server.register_job(job)
while sup.holding():
    sup.probe_once()
assert server.drain_to_idle(60)
placed = sum(
    1 for a in server.store.allocs.values() if not a.terminal_status()
)
server.stop()
verdict = preflight.run_preflight(total_s=30, device="cpu")["state"]
bad = sorted(
    m for m in sys.modules
    if m == "jax" or m.startswith("jax.") or m == "jaxlib"
    or m == "nomad_tpu" or m.startswith("nomad_tpu.")
)
print(lost, sup.state(), placed, verdict, bad)
"""


POLICY_SCRIPT = r"""
import os, sys
os.environ["NOMAD_TPU_STORM"] = "1"
os.environ["NOMAD_TPU_STORM_MIN"] = "4"
from nomad_tpu_torch import mock
from nomad_tpu_torch.server import Server
from nomad_tpu_torch.structs import PolicySpec, compute_node_class

counts = []
for batch_pipeline in (False, True):
    server = Server(batch_pipeline=batch_pipeline, device="cpu", seed=1,
                    heartbeat_ttl=1e9)
    cfg = server.store.get_scheduler_config()
    cfg.tpu_scheduler_enabled = True
    server.store.set_scheduler_config(cfg)
    for i in range(12):
        node = mock.node(id=f"nj-{i:02d}")
        node.node_class = "fast" if i % 3 == 0 else "slow"
        node.computed_class = compute_node_class(node)
        server.register_node(node)
    for k in range(6 if batch_pipeline else 1):
        job = mock.job(id=f"nj/dispatch-{k}")
        job.type = "batch" if batch_pipeline else "service"
        job.task_groups[0].count = 1 if batch_pipeline else 3
        job.policy = PolicySpec(throughput={"fast": 2.0, "slow": 1.0})
        server.register_job(job)
    server.start()
    assert server.drain_to_idle(60)
    fast = {f"nj-{i:02d}" for i in range(0, 12, 3)}
    live = [a for a in server.store.allocs.values() if not a.terminal_status()]
    counts.append((len(live), all(a.node_id in fast for a in live),
                   server.workers[0].errors))
    if batch_pipeline:
        counts.append(server.workers[0].storm_solves)
    server.stop()
bad = sorted(
    m for m in sys.modules
    if m == "jax" or m.startswith("jax.") or m == "jaxlib"
    or m == "nomad_tpu" or m.startswith("nomad_tpu.")
)
print(counts, bad)
"""


BENCH_SCRIPT = r"""
import os, sys
os.environ.update(BENCH_NODES="40", BENCH_ALLOCS="200", BENCH_E2E_JOBS="4",
                  BENCH_E2E_ORACLE_JOBS="2", BENCH_PACED_JOBS="2",
                  BENCH_SWEEP_JOBS="1", BENCH_KERNEL_NODES="40",
                  BENCH_KERNEL_E="2")
import contextlib, io, json
from nomad_tpu_torch import bench
out = io.StringIO()
with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
    rc = bench.main(["--device", "cpu"])
line = json.loads(out.getvalue())
bad = sorted(
    m for m in sys.modules
    if m == "jax" or m.startswith("jax.") or m == "jaxlib"
    or m == "nomad_tpu" or m.startswith("nomad_tpu.") or m == "bench"
)
print(rc, line["parity_identical_evals"], bad)
"""


MESH_SCRIPT = r"""
import os, sys, tempfile
import torch
import torch.distributed as dist
from nomad_tpu_torch.ops.batch import patch_rows_sharded
from nomad_tpu_torch.ops.cases import sharded_chain_case
from nomad_tpu_torch.parallel import DistMesh, VirtualMesh, sharded_chained_plan
from nomad_tpu_torch.parallel.multichip import multichip_sweep
from nomad_tpu_torch.state.convert import sharded_case_args

case = sharded_chain_case(5, 64, 60, "spread_even", 2, 3)
args = sharded_case_args(case)
run = sharded_chained_plan(VirtualMesh(4, "cpu"), 3, with_spread=True,
                           spread_even=True, return_carry=True)
rows, _pulls, carry = run(*args)
init = os.path.join(tempfile.mkdtemp(), "init")
dist.init_process_group("gloo", init_method="file://" + init, world_size=1,
                        rank=0)
mesh = DistMesh(device="cpu")
drows = sharded_chained_plan(mesh, 3, with_spread=True, spread_even=True)(*args)[0]
patch_rows_sharded(mesh, mesh.shard(torch.zeros(64, dtype=torch.float64)),
                   torch.tensor([3, 64], dtype=torch.int32),
                   torch.ones(2, dtype=torch.float64))
dist.destroy_process_group()
block = multichip_sweep(device="cpu", C=64, E=4, P=2, chunk=2, rounds=1,
                        multihost=False)
bad = sorted(
    m for m in sys.modules
    if m == "jax" or m.startswith("jax.") or m == "jaxlib"
    or m == "nomad_tpu" or m.startswith("nomad_tpu.")
)
print(bool(torch.equal(rows, drows)), len(block["points"]), bad)
"""


MESH_SERVER_SCRIPT = r"""
import os, sys, tempfile
import torch
import torch.distributed as dist
from nomad_tpu_torch import mock
from nomad_tpu_torch.ops.cases import storm_case
from nomad_tpu_torch.ops.solve import storm_assignment_sharded
from nomad_tpu_torch.parallel import DistMesh, VirtualMesh
from nomad_tpu_torch.server import Server
from nomad_tpu_torch.state.convert import storm_columns, storm_inputs

os.environ["NOMAD_TPU_STORM"] = "1"
os.environ["NOMAD_TPU_STORM_MIN"] = "4"
server = Server(batch_pipeline=True, device="cpu", seed=1,
                heartbeat_ttl=1e9, mesh=VirtualMesh(2, "cpu"))
for i in range(16):
    server.register_node(mock.node(id=f"nj-{i:02d}"))
for k in range(6):
    job = mock.job(id=f"fam/dispatch-{k:04d}")
    job.type = "batch"
    job.task_groups[0].count = 1
    server.register_job(job)
server.start()
assert server.drain_to_idle(60)
job = mock.job(id="plain")
job.task_groups[0].count = 3
server.register_job(job)
assert server.drain_to_idle(60)
worker = server.workers[0]
placed = sum(
    1 for a in server.store.allocs.values() if not a.terminal_status()
)
server.stop()
cols, inp, max_rounds = storm_case(3, 4, 16, 64, "dogpile")
init = os.path.join(tempfile.mkdtemp(), "init")
dist.init_process_group("gloo", init_method="file://" + init, world_size=1,
                        rank=0)
out = storm_assignment_sharded(DistMesh(device="cpu"), False, max_rounds)(
    storm_inputs(inp, "cpu"), storm_columns(cols, "cpu"))
dist.destroy_process_group()
bad = sorted(
    m for m in sys.modules
    if m == "jax" or m.startswith("jax.") or m == "jaxlib"
    or m == "nomad_tpu" or m.startswith("nomad_tpu.")
)
print(placed, worker.mesh_used > 0, worker.mesh_storms, int(out.rounds) > 0,
      bad)
"""


DIST_SCRIPT = r"""
import sys
from nomad_tpu_torch.parallel import dist_smoke, pod
from nomad_tpu_torch.parallel.dist_smoke import launch, launch_pod

row = launch(procs=2, shards_per_proc=2, device="cpu", timeout=120,
             extra_env={"PYTHONHASHSEED": "0"})
head = launch_pod(shards_per_proc=2, device="cpu", timeout=120,
                  extra_env={"PYTHONHASHSEED": "0"})
bad = sorted(
    m for m in sys.modules
    if m == "jax" or m.startswith("jax.") or m == "jaxlib"
    or m == "nomad_tpu" or m.startswith("nomad_tpu.")
)
print(row["zero_lost"], row["loaded"], head["digests_checked"] > 0,
      head["loaded"], head["peer"]["loaded"], bad)
"""


ENTRY_SCRIPT = r"""
import sys
from nomad_tpu_torch.entry import dryrun_multichip, entry

fn, args = entry("cpu")
row = int(fn(*args)[0])
out = dryrun_multichip(8, "cpu")
bad = sorted(
    m for m in sys.modules
    if m == "jax" or m.startswith("jax.") or m == "jaxlib"
    or m == "nomad_tpu" or m.startswith("nomad_tpu.")
    or m == "__graft_entry__"
)
print(row >= 0, out["axes"], tuple(out["rows"].shape), len(out["placements"]),
      bad)
"""


# a stopped Server's daemon sweepers outlive stop(): each script flushes
# its output and leaves without the interpreter's shutdown, which one of
# them could abort after the line is printed
EXIT = r"""
import os as _os, sys as _sys
_sys.stdout.flush()
_sys.stderr.flush()
_os._exit(0)
"""


def _run_fresh(script):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    )
    out = subprocess.run(
        [sys.executable, "-c", script + EXIT], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


def test_port_schedule_loads_no_jax():
    assert _run_fresh(SCRIPT) == "4 []"


def test_port_batched_server_loads_no_jax():
    """The batched pipeline (BatchWorker, K3's twin, the plan applier)
    drains in a fresh interpreter without JAX or the JAX package."""
    assert _run_fresh(SERVER_SCRIPT) == "12 True []"


def test_port_storm_solve_loads_no_jax():
    """A family storm (build_storm_problem, K5's twin, decompose, the
    prescored replay) drains in a fresh interpreter without JAX or the
    JAX package."""
    assert _run_fresh(STORM_SCRIPT) == "6 1 []"


def test_port_preemption_loads_no_jax():
    """A preemption-mode select (the evict evaluation, K6's twin) and
    the explain ring run in a fresh interpreter without JAX or the JAX
    package."""
    assert _run_fresh(PREEMPT_SCRIPT) == "1 True 0 []"


def test_port_bridge_loads_no_jax():
    """The port's BridgeService answers a ScoreBatch over the framed wire
    protocol (the port's codec, K7's twin) in a fresh interpreter
    without JAX or the JAX package."""
    assert _run_fresh(BRIDGE_SCRIPT) == "[3, 2] []"


def test_port_device_supervisor_loads_no_jax():
    """The device supervisor walks HEALTHY -> LOST -> HEALTHY under an
    injected flaky canary (K8's twin), holds and then places a job, and
    the preflight answers, in a fresh interpreter without JAX or the
    JAX package."""
    assert _run_fresh(DEVICE_SCRIPT) == "LOST HEALTHY 4 HEALTHY []"


def test_port_policy_weighted_loads_no_jax():
    """A weighted select through the sequential Server's CUDA stack (K1's
    twin with policy terms) and a weighted storm through the batched
    Server (K5's twin with policy rows) place on the fast class in a
    fresh interpreter without JAX or the JAX package."""
    assert _run_fresh(POLICY_SCRIPT) == "[(3, True, 0), (6, True, 0), 1] []"


def test_port_bench_loads_no_jax():
    """The port's bench (the e2e headline through the batched Server and
    the host oracle, then the kernel-only rates through K9's and K10's
    twins) runs in a fresh interpreter without JAX, the JAX package or
    the JAX package's `bench.py`."""
    assert _run_fresh(BENCH_SCRIPT) == "0 2 []"


def test_port_mesh_loads_no_jax():
    """The node mesh, K12's and K13's twins on a VirtualMesh and on a
    one-rank gloo group, and the multichip sweep run in a fresh
    interpreter without JAX or the JAX package."""
    assert _run_fresh(MESH_SCRIPT) == "True 4 []"


def test_port_mesh_server_loads_no_jax():
    """The meshed batched Server (K12's and K13's twins over the sharded
    mirror, a storm through K14's twin) and the sharded storm solve on a
    one-rank gloo group run in a fresh interpreter without JAX or the
    JAX package."""
    assert _run_fresh(MESH_SERVER_SCRIPT) == "9 True 1 True []"


def test_port_multi_process_world_loads_no_jax():
    """The lockstep world of 2 gloo ranks x 2 shards (`dist_smoke.launch`)
    and a pod (a head Server and a `pod.py` peer) run with neither JAX
    nor the JAX package in the launcher or in any spawned rank, head or
    peer (each reports its own `sys.modules`)."""
    assert _run_fresh(DIST_SCRIPT) == "True [] True [] [] []"


def test_port_entry_module_loads_no_jax():
    """The port's entry module (`entry()`, `dryrun_multichip(8)` on a 2 x
    4 VirtualMesh: the sharded select and batched planner, the meshed
    Server) runs in a fresh interpreter without JAX, the JAX package or
    `__graft_entry__`."""
    assert _run_fresh(ENTRY_SCRIPT) == "True (2, 4) (4, 3) 8 []"


def test_port_sources_import_no_jax():
    offenders = []
    sources = sorted(PORT.rglob("*.py")) + [
        REPO / name for name in ("chip_smoke.py", "chain_timing.py",
                                 "mirror_probe_timing.py",
                                 "row_patch_timing.py", "storm_timing.py",
                                 "picks_timing.py")]
    scanned = {p.relative_to(REPO).as_posix() for p in sources}
    # the storm, preemption and bridge slices' modules are in the scan
    assert {"nomad_tpu_torch/ops/solve.py",
            "nomad_tpu_torch/sched/storm.py",
            "nomad_tpu_torch/server/batch_worker.py",
            "nomad_tpu_torch/explain.py",
            "nomad_tpu_torch/ops/_cuda.py",
            "nomad_tpu_torch/sched/cuda_stack.py",
            "nomad_tpu_torch/wire.py",
            "nomad_tpu_torch/server/bridge_service.py",
            "nomad_tpu_torch/device/__init__.py",
            "nomad_tpu_torch/device/core.py",
            "nomad_tpu_torch/device/config.py",
            "nomad_tpu_torch/device/faults.py",
            "nomad_tpu_torch/device/preflight.py",
            "nomad_tpu_torch/device/supervisor.py",
            "nomad_tpu_torch/device/watchdog.py",
            "nomad_tpu_torch/ops/canary.py",
            "nomad_tpu_torch/sched/policy.py",
            "nomad_tpu_torch/parallel/__init__.py",
            "nomad_tpu_torch/parallel/mesh.py",
            "nomad_tpu_torch/parallel/multichip.py",
            "nomad_tpu_torch/parallel/pod.py",
            "nomad_tpu_torch/parallel/dist_smoke.py",
            "nomad_tpu_torch/server/server.py",
            "nomad_tpu_torch/entry.py",
            "chip_smoke.py", "chain_timing.py", "storm_timing.py",
            "picks_timing.py"} <= scanned
    for path in sources:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                root = name.split(".")[0]
                if root in ("jax", "jaxlib", "nomad_tpu", "__graft_entry__"):
                    offenders.append(f"{path.relative_to(REPO)}: {name}")
    assert not offenders, offenders
