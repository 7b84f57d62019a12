"""Scheduler bridge service: the port's copy of
`nomad_tpu/server/bridge_service.py`.

The process seam of BASELINE.json's north star: an external control plane
(the reference's Go scheduling worker, loading native/libnomadwire.so as
its cgo shim) dispatches evaluations to this service over the framed wire
protocol, and the service answers with placement decisions computed by
the batched pick kernel (K7, `ops.batch.batch_plan_picks_shared`) on the
server's device, leaving the caller's eval broker, plan applier and
replication machinery untouched.

RPC surface (method -> body -> response):

  TPUScheduler.Ping      {}                      -> {"ok": true, ...}
  TPUScheduler.ScoreBatch
      {"evals": [{"eval_id": ..., "job_id": ..., "seed": int,
                  "count": int, "cpu": int, "memory_mb": int,
                  "disk_mb": int}, ...]}
      -> {"results": [{"eval_id": ..., "nodes": [node_id, ...]}, ...]}

Each eval's `seed` drives the shuffled visit order exactly as the
in-process schedulers do, so decisions are bit-identical to the JAX
service's on the same world, whichever side of the bridge asks.  An
exception (a failed build, launch or fetch of K7 included) is answered
as `{"error": ...}`; nothing is recomputed on the CPU.

Each connection is served on its own thread.  On the card that thread
launches K7 on a stream of its own and its one device-to-host copy waits
for that stream alone, so calls do not queue behind each other or
behind a batch worker's stream.  A call copies the node table's columns
once, under the store's lock, so a server placing allocs meanwhile
cannot tear one answer.
"""
from __future__ import annotations

import contextlib
import math
import random
import socketserver
import threading
from typing import Dict, Optional

import numpy as np
import torch

from ..ops.batch import batch_plan_picks_shared
from ..sched.feasible import shuffle_permutation
from ..state.convert import batch_shared_inputs_from_numpy
from ..wire import decode, encode, recv_frame, send_frame

_COLUMNS = ("cpu_total", "mem_total", "disk_total", "cpu_used", "mem_used",
            "disk_used")


class BridgeService:
    def __init__(self, server, host: str = "127.0.0.1", port: int = 0):
        self.server = server
        self.store = server.store
        self.device = server.device

        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self) -> None:
                with outer._connection_stream():
                    self._serve()

            def _serve(self) -> None:
                while True:
                    try:
                        frame = recv_frame(self.request)
                    except (ConnectionError, ValueError, OSError):
                        return
                    if frame is None:
                        return
                    try:
                        method, body = decode(frame)
                        response = outer.dispatch(method, body)
                    except Exception as exc:  # noqa: BLE001
                        response = {"error": f"{type(exc).__name__}: {exc}"}
                    try:
                        send_frame(self.request, encode(response))
                    except OSError:
                        return

        class TCP(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self.tcp = TCP((host, port), Handler)
        self.port = self.tcp.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def _connection_stream(self):
        """The current stream of a connection's thread: a stream of its
        own on the card, nothing on the CPU."""
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        return torch.cuda.stream(torch.cuda.Stream(self.device))

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self.tcp.serve_forever, name="tpu-bridge", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self.tcp.shutdown()
        self.tcp.server_close()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    # ------------------------------------------------------------------

    def dispatch(self, method: str, body: Dict) -> Dict:
        if method == "TPUScheduler.Ping":
            return {
                "ok": True,
                "nodes": len(self.store.nodes),
                "arena": self.store.node_table.capacity,
            }
        if method == "TPUScheduler.ScoreBatch":
            return self.score_batch(body)
        return {"error": f"unknown method {method!r}"}

    # ------------------------------------------------------------------

    def score_batch(self, body: Dict) -> Dict:
        """Run a batch of simple binpack evals through the batched pick
        kernel against one copy of the live node table."""
        evals = body.get("evals") or []
        if not evals:
            return {"results": []}

        table = self.store.node_table
        # one consistent copy: the store mutates the table under its lock
        with self.store._lock:
            C = table.capacity
            ready_rows = [
                row
                for node_id, row in table.row_of.items()
                if table.eligible[row]
            ]
            node_ids = list(table.node_ids)
            cols = {name: getattr(table, name).copy() for name in _COLUMNS}
        n_cand = len(ready_rows)
        if n_cand == 0:
            return {
                "results": [
                    {"eval_id": e.get("eval_id", ""), "nodes": []}
                    for e in evals
                ]
            }
        base_rows = np.asarray(sorted(ready_rows), dtype=np.int32)
        rest = np.setdiff1d(np.arange(C, dtype=np.int32), base_rows)
        feasible = np.zeros(C, dtype=bool)
        feasible[base_rows] = True

        limit = max(2, math.ceil(math.log2(n_cand)))
        max_picks = max(int(e.get("count", 1)) for e in evals)
        if max_picks < 1:
            # the JAX service fails here too (a pick scan of length 0)
            raise ValueError("no eval in the batch asks for a placement")

        perms = np.empty((len(evals), C), dtype=np.int32)
        asks = np.zeros((len(evals), 3))
        counts = np.zeros(len(evals), np.int32)
        for k, e in enumerate(evals):
            rng = random.Random(int(e.get("seed", 0)))
            order = shuffle_permutation(rng, n_cand)
            perms[k, :n_cand] = base_rows[order]
            perms[k, n_cand:] = rest
            asks[k] = (
                float(e.get("cpu", 100)),
                float(e.get("memory_mb", 300)),
                float(e.get("disk_mb", 300)),
            )
            counts[k] = int(e.get("count", 1))

        kw = batch_shared_inputs_from_numpy(
            dict(
                cpu_total=cols["cpu_total"], mem_total=cols["mem_total"],
                disk_total=cols["disk_total"], feasible=feasible,
                base_cpu_used=cols["cpu_used"],
                base_mem_used=cols["mem_used"],
                base_disk_used=cols["disk_used"], perms=perms,
                ask_cpu=asks[:, 0], ask_mem=asks[:, 1], ask_disk=asks[:, 2],
                desired_count=counts,
                limit=np.full(len(evals), limit, np.int32),
                n_candidates=n_cand, n_picks=int(max_picks),
            ),
            self.device,
        )
        # the one device-to-host copy; on the card it waits for this
        # thread's stream only
        rows = batch_plan_picks_shared(**kw).cpu().numpy()

        results = []
        for k, e in enumerate(evals):
            chosen = [
                node_ids[r]
                for r in rows[k, : counts[k]]
                if r >= 0
            ]
            results.append(
                {"eval_id": e.get("eval_id", ""), "nodes": chosen}
            )
        return {"results": results}
