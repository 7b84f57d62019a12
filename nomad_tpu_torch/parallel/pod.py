"""Pod composition: a live worker heads a multi-process mesh (the port of
`nomad_tpu/parallel/pod.py`).

A world of processes whose workers run in lockstep (every process the
same worker over the same inputs in the same order, as `dist_smoke.py`
drives them) needs nothing more than the mesh.  A worker that leases
evals at its own pace cannot be followed that way, so this module makes
its process the HEAD of the NOMAD_TPU_DIST* world and streams its launch
sequence to the other members (PEERS) over an ordered TCP channel:

* the head sends each mesh operation (mirror full, bulk or delta sync,
  chain launch, storm solve) as one framed message, THEN executes it;
* each peer executes the messages strictly in the order received.

TCP's FIFO delivery makes every member issue the same collectives in the
same order, while what needs no collective (the placement of host
columns as each process's own shards, `mesh.mesh_put`) stays local.  A
mirror delta re-runs the per-host flush on the peer: the head ships only
the sorted dirty rows and their three value columns (O(dirty rows) bytes
on the wire), and the peer builds its own shard-local staging from them
(`ops.batch.hostlocal_staging`) and stores it with K15
(`patch_rows_hostlocal`).  Device tensors never cross the wire: a
chain's usage columns come from the peer's own mirror ("mirror") or its
own previous launch's carry ("carry"), which track the head's bit for
bit because both applied the same stream.  Chains run through K12
(`sharded_chained_plan`, the carry threaded), storms through K14
(`ops.solve.storm_assignment_sharded` over `sched.storm.stage_for_mesh`).

``NOMAD_TPU_POD_PORT`` (the head's listen port) turns the head side on
in `BatchWorker._attach_pod`, for a world whose width is one of
`MESH_FANOUT_WIDTHS` (any other raises: the worker stops, it never runs
unsharded); peers run ``python -m nomad_tpu_torch.parallel.pod
--head-port PORT`` with the same NOMAD_TPU_DIST* world knobs and a
nonzero NOMAD_TPU_DIST_ID.  ``NOMAD_TPU_POD_CHECK=1`` makes every chain
and storm round-trip a digest of its result from every peer, which must
equal the head's.  A peer loads its kernels before it dials the head,
and runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import socket
import struct
import sys
import threading
import time
from typing import Dict, List, Optional

import numpy as np

# the global shard counts a pod-headed mesh may span (the JAX package's
# ops/contracts.py MESH_FANOUT_WIDTHS); another width raises at the head
MESH_FANOUT_WIDTHS = (2, 4, 8)

_LEN = struct.Struct(">Q")


def send_msg(sock: socket.socket, obj) -> None:
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_LEN.pack(len(data)) + data)


def recv_msg(sock: socket.socket):
    head = _recv_exact(sock, _LEN.size)
    (n,) = _LEN.unpack(head)
    return pickle.loads(_recv_exact(sock, n))


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("pod channel closed mid-message")
        buf.extend(chunk)
    return bytes(buf)


def pod_check_enabled() -> bool:
    return os.environ.get("NOMAD_TPU_POD_CHECK") == "1"


def _host(x) -> np.ndarray:
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def result_digest(*arrays) -> str:
    """Order-stable digest of replicated outputs (numpy arrays or
    tensors, read back to the host), the same on head and peer."""
    import hashlib

    h = hashlib.sha256()
    for a in arrays:
        arr = np.ascontiguousarray(_host(a))
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


class PodService:
    """Head side: accepts the world's peer connections and broadcasts
    the mesh-operation stream in FIFO order.  Every send holds one lock:
    messages interleaved from two threads would put the peers'
    collectives in another order than the head's."""

    def __init__(self, port: int, n_peers: int) -> None:
        self.n_peers = n_peers
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind(("127.0.0.1", port))
        self.port = self._srv.getsockname()[1]
        self._srv.listen(max(1, n_peers))
        self._peers: List[socket.socket] = []
        self._lock = threading.Lock()
        self._accept_cond = threading.Condition(self._lock)
        self._closed = False
        self.check = pod_check_enabled()
        # digests compared so far (NOMAD_TPU_POD_CHECK), one per launch
        self.checked = 0
        self.sent: Dict[str, int] = {}
        t = threading.Thread(target=self._accept_loop, name="pod-accept",
                             daemon=True)
        t.start()

    def _accept_loop(self) -> None:
        while True:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return  # listener closed
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                self._peers.append(conn)
                self._accept_cond.notify_all()
                if len(self._peers) >= self.n_peers:
                    return

    def wait_peers(self, timeout: float = 120.0) -> None:
        deadline = time.monotonic() + timeout
        with self._lock:
            while len(self._peers) < self.n_peers:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"pod head: {len(self._peers)}/{self.n_peers} "
                        "peers connected")
                self._accept_cond.wait(remaining)

    def send(self, kind: str, *payload) -> None:
        """Broadcast one operation.  Blocks until the whole world is
        connected: a collective executed before every member can follow
        would leave the pod waiting at it."""
        self.wait_peers()
        with self._lock:
            if self._closed:
                raise RuntimeError("pod service closed")
            for sock in self._peers:
                send_msg(sock, (kind,) + payload)
            self.sent[kind] = self.sent.get(kind, 0) + 1

    def check_results(self, digest: str) -> None:
        """NOMAD_TPU_POD_CHECK: one digest from each peer for the launch
        just executed, each equal to the head's."""
        if not self.check:
            return
        with self._lock:
            for sock in self._peers:
                got = recv_msg(sock)
                if got != ("digest", digest):
                    raise AssertionError(
                        f"pod parity: peer digest {got!r} != head {digest!r}")
            self.checked += 1

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            for sock in self._peers:
                try:
                    send_msg(sock, ("bye",))
                except OSError:
                    pass
                try:
                    sock.close()
                except OSError:
                    pass
            try:
                self._srv.close()
            except OSError:
                pass


def build_worker_mesh(device=None):
    """The worker's mesh bring-up, shared by head
    (`BatchWorker._make_mesh`) and peer: join the NOMAD_TPU_DIST* world,
    then lay every rank's NOMAD_TPU_SHARDS_PER_RANK shards along the node
    axis, capped by NOMAD_TPU_MESH_DEVICES (a cap below the world's
    shards raises), on `device` (the card unless ``"cpu"``).  The same
    environment gives every member the same mesh, which the collective
    programs require.  A missing group, or a mesh of one shard, raises:
    nothing runs unsharded in its place."""
    import torch.distributed as dist

    from .mesh import distributed_init, make_mesh, shards_per_rank

    distributed_init()
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "NOMAD_TPU_MESH=1 needs the Server's mesh= or an initialised "
            "torch.distributed group (or the NOMAD_TPU_DIST* world knobs)")
    per = shards_per_rank()
    n = dist.get_world_size() * per
    try:
        cap = int(os.environ.get("NOMAD_TPU_MESH_DEVICES", "0"))
    except ValueError:
        cap = 0
    if cap > 0:
        n = min(n, cap)
    if n <= 1:
        raise ValueError(
            f"NOMAD_TPU_MESH=1 over {n} shard: a node mesh needs more than "
            "one (or the Server's mesh=)")
    return make_mesh(n, eval_axis=1, device=device, shards_per_rank=per)


def launch_counts() -> dict:
    """This process's launches of the mesh path's kernels (K12, K13, K14,
    K15, and K5 for the single-device solve): 0 on the CPU, where the
    twins run."""
    from ..ops import batch as tbatch
    from ..ops import solve as tsolve
    from .mesh import sharded_chained_plan_cuda

    return {
        "sharded_chained_plan": sharded_chained_plan_cuda.launches,
        "patch_rows_sharded": tbatch.patch_rows_sharded_cuda.launches,
        "storm_assignment_sharded": tsolve.storm_assignment_sharded_cuda.launches,
        "patch_rows_hostlocal": tbatch.patch_rows_hostlocal_cuda.launches,
        "storm_solve": tsolve.storm_assignment_cuda.launches,
    }


def foreign_modules() -> list:
    """Modules of JAX or of the JAX package this process has loaded: none
    may be (the port stands alone)."""
    return sorted(m for m in sys.modules
                  if m in ("jax", "jaxlib", "nomad_tpu")
                  or m.startswith(("jax.", "jaxlib.", "nomad_tpu.")))


class PodPeer:
    """Peer side: the device-resident state (the sharded usage mirror and
    the running chain carry) and the message loop that replays the
    head's operation stream against it."""

    def __init__(self, mesh) -> None:
        self.mesh = mesh
        self.mirror: Optional[tuple] = None
        self.carry = None
        self.check = pod_check_enabled()
        self.ops: Dict[str, int] = {}

    def _upload(self, arr) -> "torch.Tensor":  # noqa: F821
        import torch

        return torch.from_numpy(np.array(arr)).to(self.mesh.device)

    # -- registry ops (one per head-side message kind) ------------------

    def mirror_full(self, host_cols) -> None:
        from .mesh import mesh_put

        self.mirror = tuple(mesh_put(self.mesh, col) for col in host_cols)

    def mirror_bulk(self, host_used) -> None:
        from .mesh import mesh_put

        assert self.mirror is not None, "bulk before full sync"
        self.mirror = self.mirror[:3] + tuple(
            mesh_put(self.mesh, col) for col in host_used)

    def mirror_delta(self, idx, vals3, capacity) -> None:
        """The per-host flush: this process's shard-local staging rows
        from the sorted global dirty rows, each column's values gathered
        from the wire values, stored by K15 in place."""
        from ..ops.batch import hostlocal_staging, patch_rows_hostlocal

        assert self.mirror is not None, "delta before full sync"
        idx = np.asarray(idx, dtype=np.int32)
        idx_stack, per_dev, width = hostlocal_staging(self.mesh, idx, capacity)
        local = list(self.mesh.local_shards)
        idx_dev = self._upload(idx_stack[local])
        for col, vals in zip(self.mirror[3:], vals3):
            vals = np.asarray(vals)
            vals_stack = np.zeros((len(local), width), dtype=vals.dtype)
            for i, d in enumerate(local):
                sel = per_dev[d]
                # the wire values follow the sorted idx; the shard's rows
                # map back by binary search
                vals_stack[i, :len(sel)] = vals[np.searchsorted(idx, sel)]
            patch_rows_hostlocal(self.mesh, col, idx_dev,
                                 self._upload(vals_stack))

    def chain(self, meta: dict, args_tail: tuple) -> Optional[str]:
        from .mesh import sharded_chained_plan

        assert self.mirror is not None, "chain before mirror sync"
        used = self.carry if meta["used"] == "carry" else self.mirror[3:6]
        assert used is not None, "carry chain before any chunk"
        runner = sharded_chained_plan(
            self.mesh, meta["n_picks"], meta["spread_fit"],
            with_spread=meta["with_spread"],
            spread_even=meta["spread_even"], return_carry=True)
        rows, pulls, self.carry = runner(*self.mirror[:3], *used, *args_tail)
        if self.check:
            return result_digest(rows, pulls)
        # read back anyway: a failure inside the chain must surface here
        _host(rows)
        return None

    def storm(self, inputs_host, spread_fit: bool,
              max_rounds: int) -> Optional[str]:
        from ..ops.solve import StormInputs, storm_assignment_sharded
        from ..sched.storm import stage_for_mesh

        assert self.mirror is not None, "storm before mirror sync"
        inp = StormInputs(*(None if leaf is None else self._upload(leaf)
                            for leaf in inputs_host))
        fn = storm_assignment_sharded(
            self.mesh, spread_fit, max_rounds,
            weighted=inp.policy_tput_term is not None)
        out = tuple(_host(x) for x in fn(stage_for_mesh(inp, self.mesh),
                                         self.mirror))
        return result_digest(*out) if self.check else None

    def reset(self) -> None:
        self.mirror = None
        self.carry = None

    # -- message loop ---------------------------------------------------

    def serve(self, sock: socket.socket) -> None:
        while True:
            msg = recv_msg(sock)
            kind = msg[0]
            if kind == "bye":
                return
            self.ops[kind] = self.ops.get(kind, 0) + 1
            digest = None
            if kind == "mirror_full":
                self.mirror_full(msg[1])
            elif kind == "mirror_bulk":
                self.mirror_bulk(msg[1])
            elif kind == "mirror_delta":
                self.mirror_delta(msg[1], msg[2], msg[3])
            elif kind == "chain":
                digest = self.chain(msg[1], msg[2])
            elif kind == "storm":
                digest = self.storm(msg[1], msg[2], msg[3])
            elif kind == "reset":
                self.reset()
            else:
                raise ValueError(f"unknown pod message {kind!r}")
            if digest is not None:
                send_msg(sock, ("digest", digest))


def run_peer(head_port: int, connect_timeout: float = 120.0,
             device=None) -> dict:
    """A peer process: join the world, build the mesh, load the mesh
    path's kernels (on the card), dial the head and replay its stream
    until ``bye``.  Returns what it replayed and launched."""
    mesh = build_worker_mesh(device)
    if mesh.device.type == "cuda":
        from ..ops import _cuda

        _cuda.load(["sharded_chain", "storm_sharded", "patch_rows_hostlocal"])
    deadline = time.monotonic() + connect_timeout
    sock = None
    while sock is None:
        try:
            sock = socket.create_connection(("127.0.0.1", head_port),
                                            timeout=5.0)
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.2)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    sock.settimeout(None)
    print(f"POD_PEER_READY port={head_port}", flush=True)
    peer = PodPeer(mesh)
    try:
        peer.serve(sock)
    finally:
        sock.close()
    return {"ops": peer.ops, "launches": launch_counts(),
            "shards": list(mesh.local_shards), "loaded": foreign_modules()}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="nomad-tpu pod peer (a member of the mesh's world)")
    parser.add_argument("--head-port", type=int, required=True,
                        help="the head worker's NOMAD_TPU_POD_PORT")
    parser.add_argument("--connect-timeout", type=float, default=120.0)
    parser.add_argument("--device", default=None,
                        help="cpu for the plain twins (default: the card)")
    args = parser.parse_args(argv)
    done = run_peer(args.head_port, args.connect_timeout, args.device)
    print("POD_PEER_DONE " + json.dumps(done), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
