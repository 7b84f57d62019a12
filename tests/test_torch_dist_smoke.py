"""The port's multi-process world (`nomad_tpu_torch/parallel/dist_smoke.py`
and `pod.py`) on the CPU, against the unsharded port and the JAX package.

* `launch(procs=2, shards_per_proc=2, device="cpu")` spawns a real
  2-rank gloo world and passes the asserts of the JAX package's
  `test_two_process_distributed_smoke` (zero lost, cross-host parity,
  K12's chunks, the storm solve equal to the single-device one, the
  per-host flush below the full upload, in its closed form); its
  placements equal an unsharded port Server's driven the same way and
  the JAX package's Server's on the same nodes and jobs (compared as
  `test_torch_mesh_server.py` compares them), every process with one
  PYTHONHASHSEED.
* a pod (a head Server with NOMAD_TPU_POD_CHECK=1 and one peer) streams
  every mirror sync, chain and storm; every digest matches and the
  placements equal the unsharded port's.
* a pod of an undeclared width raises at the head.

Each spawned world finishes in well under 60 s here."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from nomad_tpu_torch.parallel import dist_smoke

REPO = Path(__file__).resolve().parent.parent
SPAWN_LIMIT_S = 60.0
HASH_SEED = "0"
ENV = {"PYTHONHASHSEED": HASH_SEED}

REFERENCE = r"""
import json
from nomad_tpu_torch.parallel.dist_smoke import reference
print(json.dumps(reference("cpu")))
"""

# the JAX package's Server on the same world: its dist_smoke's recipes
# (the same ids, seeds and sizes), drained as test_torch_mesh_server
# drains it, the family registered under the broker's lock as one wave
JAX_REFERENCE = r"""
import json, os
os.environ["NOMAD_TPU_STORM"] = "1"
os.environ["NOMAD_TPU_STORM_MIN"] = "8"
from nomad_tpu.parallel import dist_smoke as jd
from nomad_tpu.server import Server

w = jd.smoke_world()
server = Server(num_schedulers=1, seed=29, batch_pipeline=True,
                heartbeat_ttl=600.0)
for node in jd._make_nodes(w["nodes"], seed=5):
    server.register_node(node)
jobs = jd._make_jobs(w["jobs"], seed=7)
for job in jobs:
    server.register_job(job)
server.start()
try:
    assert server.drain_to_idle(120)
    fam = jd._family_jobs(w["family"])
    with server.broker._lock:
        for job in fam:
            server.register_job(job)
    assert server.drain_to_idle(120)
    out = {"chain": jd._placements(server, jobs),
           "storm": jd._placements(server, fam)}
finally:
    server.stop()
print(json.dumps(out))
"""


def _fresh(script: str, extra: dict) -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("NOMAD_TPU_")}
    env.update(extra)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    out = subprocess.run([sys.executable, "-c", script], cwd=str(REPO),
                         env=env, capture_output=True, text=True,
                         timeout=SPAWN_LIMIT_S)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


_REF = {}


def _reference() -> dict:
    """The unsharded port Server over the same world, one process, the
    ranks' hash seed."""
    if "port" not in _REF:
        _REF["port"] = _fresh(REFERENCE, ENV)
    return _REF["port"]


def test_two_process_world_matches_unsharded_and_jax():
    row = dist_smoke.launch(procs=2, shards_per_proc=2, device="cpu",
                            timeout=SPAWN_LIMIT_S, extra_env=ENV)
    assert row["procs"] == 2
    assert row["devices_per_host"] == 2 and row["global_devices"] == 4
    assert row["device"] == "cpu" and row["pythonhashseed"] == HASH_SEED
    assert row["zero_lost"] is True
    assert row["cross_host_parity"] is True
    assert row["chain"]["mesh_launches"] >= 1
    assert row["chain"]["placements"] > 0
    assert row["storm"]["solves"] >= 1 and row["storm"]["fallbacks"] == 0
    assert row["storm_kernel"]["bit_identical"] is True
    assert row["loaded"] == []
    flush = row["flush"]
    assert flush["dirty_rows"] > 0
    assert (flush["bytes_per_flush_delta_per_host"]
            == flush["bytes_per_flush_closed_form"])
    assert (flush["bytes_per_flush_delta_per_host"]
            < flush["bytes_per_flush_full_per_host"])
    # the twins ran: no kernel launch is counted on the CPU
    assert set(row["launches"].values()) == {0}

    ref = _reference()
    assert row["chain"]["placed"] == ref["chain"]
    assert row["storm"]["placed"] == ref["storm"]
    jax = _fresh(JAX_REFERENCE, dict(ENV, JAX_PLATFORMS="cpu"))
    assert jax["chain"] == ref["chain"]
    assert jax["storm"] == ref["storm"]


def test_pod_head_and_peer_match_unsharded():
    row = dist_smoke.launch_pod(shards_per_proc=2, device="cpu",
                                timeout=SPAWN_LIMIT_S, extra_env=ENV)
    assert row["hosts"] == 2 and row["errors"] == 0
    assert row["mesh_launches"] >= 1 and row["mesh_storms"] >= 1
    # every chain and storm's digest came back equal from the peer
    assert row["digests_checked"] == row["sent"]["chain"] + row["sent"]["storm"]
    assert {"mirror_full", "mirror_delta", "chain", "storm"} <= set(row["sent"])
    assert row["peer"]["ops"] == row["sent"]
    assert row["peer"]["shards"] == [2, 3]
    assert row["loaded"] == [] and row["peer"]["loaded"] == []
    ref = _reference()
    assert row["placed"] == ref["chain"]
    assert row["storm_placed"] == ref["storm"]


UNDECLARED = r"""
import os, sys
from nomad_tpu_torch.parallel.mesh import distributed_init
assert distributed_init()
if os.environ["NOMAD_TPU_DIST_ID"] != "0":
    sys.exit(0)
from nomad_tpu_torch.server import Server
try:
    Server(device="cpu", heartbeat_ttl=1e9)
except RuntimeError as exc:
    print("RAISED", exc)
"""


def test_undeclared_pod_width_raises():
    """2 ranks x 3 shards is a pod of width 6, not one of
    `MESH_FANOUT_WIDTHS`: the head's Server raises at construction (the
    worker stops; nothing runs unsharded)."""
    port, head_port = dist_smoke._free_port(), dist_smoke._free_port()
    extra = dict(ENV, NOMAD_TPU_POD_PORT=str(head_port))
    children = [(["-c", UNDECLARED],
                 dist_smoke._child_env(port, 2, rank, 3, "cpu", extra))
                for rank in range(2)]
    tails = dist_smoke._run_children(children, SPAWN_LIMIT_S, "pod_width")
    assert "RAISED undeclared fan-out pod width 6" in tails[0]


def test_a_failed_rank_raises_with_its_log():
    """A rank that fails makes `launch` raise with the ranks' log tails,
    within its timeout: nothing hangs.  Here 2 ranks x 3 shards do not
    tile the tiny world's 16-row arena, which each rank checks."""
    with pytest.raises(RuntimeError, match="rcs="):
        dist_smoke.launch(procs=2, shards_per_proc=3, device="cpu",
                          timeout=SPAWN_LIMIT_S, extra_env=ENV)
