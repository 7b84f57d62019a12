"""In-memory indexed state store.

Plays the role of the reference's go-memdb `StateStore`
(`nomad/state/state_store.go`, schema `nomad/state/schema.go:59`): tables
for nodes, jobs (+versions), allocs, evals, deployments, job summaries and
scheduler config, each with a modify-index, plus `upsert_plan_results`
(state_store.go:240), the single write path for scheduler plans.

Concurrency model (a deliberate departure from go-memdb's MVCC): the
control plane is a single-process event loop where plan application is
serialized (as in the reference, `nomad/plan_apply.go:45-70`), so a
"snapshot" is an O(1) fence — it records the current index and delegates
reads to the live tables; no mutation can interleave with a scheduler pass.
This keeps eval throughput free of O(cluster) snapshot copies, which
matters when the scoring backend is fast enough that snapshotting would
dominate.  `SnapshotAt` provides the same `snapshot_min_index` wait the
reference workers use (state_store.go:127).

The store also owns the columnar `NodeTable` mirror (the device-resident
"cluster tensor") and keeps it incrementally in sync on node/alloc writes.
"""
from __future__ import annotations

import threading
import time
from collections import defaultdict
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

from ..trace import TRACE
from ..structs import (
    Allocation,
    ALLOC_CLIENT_STATUS_FAILED,
    ALLOC_CLIENT_STATUS_LOST,
    ALLOC_DESIRED_STOP,
    CSIPlugin,
    CSIVolume,
    Deployment,
    Evaluation,
    Job,
    JOB_STATUS_DEAD,
    JOB_STATUS_PENDING,
    JOB_STATUS_RUNNING,
    JOB_TYPE_SYSTEM,
    Namespace,
    Node,
    Plan,
    PlanResult,
    JOB_TRACKED_SCALING_EVENTS,
    ScalingEvent,
    ScalingPolicy,
    SchedulerConfiguration,
    compute_node_class,
)
from .node_table import NodeTable


class StateStore:
    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._index = 0
        self._table_index: Dict[str, int] = defaultdict(int)

        self.nodes: Dict[str, Node] = {}
        self.jobs: Dict[Tuple[str, str], Job] = {}
        self.job_versions: Dict[Tuple[str, str], List[Job]] = defaultdict(list)
        self.allocs: Dict[str, Allocation] = {}
        self.evals: Dict[str, Evaluation] = {}
        self.deployments: Dict[str, Deployment] = {}
        self.scheduler_config = SchedulerConfiguration()
        # autopilot operator config; None = compiled-in defaults
        self.autopilot_config = None

        # CSI volumes keyed (namespace, id) (reference state table
        # csi_volumes, nomad/state/schema.go)
        self.csi_volumes: Dict[Tuple[str, str], CSIVolume] = {}

        # namespaces (reference state table namespaces); "default"
        # always exists
        self.namespaces: Dict[str, "Namespace"] = {
            "default": Namespace(
                name="default", description="Default shared namespace"
            )
        }

        # autoscaling (reference state tables scaling_policy /
        # scaling_event, nomad/state/schema.go:795,847)
        self.scaling_policies: Dict[str, "ScalingPolicy"] = {}
        self._scaling_by_target: Dict[Tuple[str, str, str], str] = {}
        self.scaling_events: Dict[
            Tuple[str, str], Dict[str, List["ScalingEvent"]]
        ] = defaultdict(dict)

        # secondary indexes
        self._allocs_by_node: Dict[str, set] = defaultdict(set)
        self._allocs_by_job: Dict[Tuple[str, str], set] = defaultdict(set)
        self._allocs_by_eval: Dict[str, set] = defaultdict(set)
        self._evals_by_job: Dict[Tuple[str, str], set] = defaultdict(set)
        self._deployments_by_job: Dict[Tuple[str, str], set] = defaultdict(set)

        # columnar mirror of the node table + per-node live-usage columns
        self.node_table = NodeTable()
        # per-node mutation fingerprints: node_id -> count of writes
        # that touched that node's scheduling-relevant state (node
        # record writes AND each alloc write on the node).  The
        # BatchWorker's optimistic parallel replay uses them as its
        # conflict ledger: a speculative replay may only commit when
        # every node it read shows exactly the touch count it expects
        # (wave-start baseline plus the wave's own committed plans) —
        # any external write inflates the count and conflicts.  One
        # int per live node (entries are pruned on delete_node, so
        # node churn doesn't accumulate dead ids).
        self._node_touch: Dict[str, int] = {}
        # bumped only when the READY-node set can have changed (join,
        # leave, status/eligibility/drain flips) — the global conflict
        # fence for reads that scan all candidates (ready_nodes_in_dcs)
        self._readiness_gen = 0
        # live allocated static host ports: port -> {node_id: count},
        # plus the reverse map so per-node refresh never scans the
        # whole port dict
        self._ports_live: Dict[int, Dict[str, int]] = {}
        self._ports_by_node: Dict[str, set] = {}

        # bigworld allocation ballast: per-row (cpu, mem, disk) usage
        # seeded by bulk_seed_usage WITHOUT materializing Allocation
        # objects (10M allocs as dataclasses would cost tens of GB;
        # the array ledger is three f64 columns).  _live_usage_for_node
        # adds the row's ballast on every recompute so a real alloc
        # landing on a seeded node doesn't wipe the seeded base.
        self._seed_usage: Optional[List[np.ndarray]] = None
        self._seed_alloc_count = 0

        # change notification for blocking queries
        self._watch_cond = threading.Condition(self._lock)
        self._watchers: List[Callable[[str, int], None]] = []
        self._alloc_watchers: List[
            Callable[[List[Allocation]], None]
        ] = []
        # happens-before sanitizer (NOMAD_TPU_TSAN=1): inert one env
        # read otherwise
        from ..tsan import maybe_instrument

        maybe_instrument(self, "StateStore")

    # ------------------------------------------------------------------
    # index plumbing
    # ------------------------------------------------------------------

    def latest_index(self) -> int:
        return self._index

    def table_index(self, table: str) -> int:
        return self._table_index[table]

    def _bump(self, *tables: str) -> int:
        self._index += 1
        for t in tables:
            self._table_index[t] = self._index
        self._watch_cond.notify_all()
        for cb in self._watchers:
            for t in tables:
                cb(t, self._index)
        return self._index

    def add_watcher(self, cb: Callable[[str, int], None]) -> None:
        with self._lock:
            self._watchers.append(cb)

    def add_alloc_watcher(
        self, cb: Callable[[Optional[List[Allocation]]], None]
    ) -> None:
        """Delta-level watcher: called with exactly the allocations each
        write touched, so consumers (service catalog) can update
        incrementally instead of rescanning the whole alloc table.
        A ``None`` delta means the alloc table was replaced wholesale
        (snapshot restore) — consumers must resync from scratch."""
        with self._lock:
            self._alloc_watchers.append(cb)

    def wait_for_change(
        self, last_index: int, timeout: float = 1.0
    ) -> int:
        """Block until the store index advances past ``last_index`` or
        the timeout elapses; returns the current index.  This is the
        blocking-query primitive the leader-side watchers poll with
        (reference nomad/rpc.go:780 blockingRPC), replacing fixed-rate
        full-table sweeps."""
        deadline = time.monotonic() + timeout
        with self._watch_cond:
            while self._index <= last_index:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._watch_cond.wait(remaining)
            return self._index

    def wait_for_index(self, index: int, timeout: float = 5.0) -> bool:
        """Block until the store has advanced to at least ``index``
        (reference state_store.go:127 SnapshotMinIndex)."""
        deadline = time.monotonic() + timeout
        with self._watch_cond:
            while self._index < index:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._watch_cond.wait(remaining)
            return True

    def snapshot(self) -> "StateSnapshot":
        return StateSnapshot(self, self._index)

    def snapshot_min_index(self, index: int, timeout: float = 5.0) -> "StateSnapshot":
        if not self.wait_for_index(index, timeout):
            raise TimeoutError(
                f"timeout waiting for state at index {index} (at {self._index})"
            )
        return self.snapshot()

    # ------------------------------------------------------------------
    # nodes
    # ------------------------------------------------------------------

    def upsert_node(self, node: Node) -> int:
        with self._lock:
            if not node.computed_class:
                node.computed_class = compute_node_class(node)
            existing = self.nodes.get(node.id)
            if existing is not None:
                node.create_index = existing.create_index
            else:
                node.create_index = self._index + 1
            node.modify_index = self._index + 1
            was_ready = existing is not None and existing.ready()
            self.nodes[node.id] = node
            self.node_table.upsert_node(node)
            index = self._bump("nodes")
            self._touch_node(node.id)
            if existing is None or was_ready != node.ready():
                self._readiness_gen += 1
            # a changed node address must refresh the catalog entries of
            # allocs already running there (their instances captured the
            # old address when the alloc was last written)
            if (
                existing is not None
                and self._alloc_watchers
                and self._node_address(existing)
                != self._node_address(node)
            ):
                touched = [
                    self.allocs[aid]
                    for aid in self._allocs_by_node.get(node.id, ())
                    if aid in self.allocs
                ]
                self._notify_alloc_watchers(touched)
            return index

    @staticmethod
    def _node_address(node: Node) -> str:
        nets = node.node_resources.networks
        return nets[0].ip if nets else ""

    def bulk_register_nodes(self, nodes: List[Node]) -> int:
        """Register many FRESH synthetic nodes under ONE index bump —
        the bigworld seeding path.  Callers pre-set computed_class
        (the per-node class hash over a million template-sharing nodes
        is pure waste) and guarantee the ids are new.  Per-node touch
        counts are not seeded: an absent entry reads as 0, which is a
        valid conflict-ledger baseline."""
        if not nodes:
            return self._index
        with self._lock:
            idx = self._index + 1
            for node in nodes:
                node.create_index = idx
                node.modify_index = idx
                self.nodes[node.id] = node
            self.node_table.bulk_register_nodes(nodes)
            self._readiness_gen += 1
            return self._bump("nodes")

    def bulk_seed_usage(
        self,
        rows: np.ndarray,
        cpu: np.ndarray,
        mem: np.ndarray,
        disk: np.ndarray,
        alloc_count: int = 0,
    ) -> int:
        """Add allocation ballast to node rows as array columns — the
        usage the rows' live allocs WOULD exert if ``alloc_count``
        Allocation objects had been upserted, without materializing
        any of them.  Idempotent consumers see it as a normal usage
        delta (one generation, all touched rows dirty)."""
        with self._lock:
            cap = self.node_table.capacity
            if self._seed_usage is None or len(
                self._seed_usage[0]
            ) < cap:
                grown = [
                    np.zeros(cap, dtype=np.float64) for _ in range(3)
                ]
                if self._seed_usage is not None:
                    for g, o in zip(grown, self._seed_usage):
                        g[: len(o)] = o
                self._seed_usage = grown
            # this call's per-row aggregate (many allocs can land on
            # one row), folded into both the persistent ballast and
            # the live usage columns on top of whatever real allocs
            # already exert there
            agg = [np.zeros(cap, dtype=np.float64) for _ in range(3)]
            np.add.at(agg[0], rows, cpu)
            np.add.at(agg[1], rows, mem)
            np.add.at(agg[2], rows, disk)
            for base, a in zip(self._seed_usage, agg):
                base += a
            touched = np.unique(rows)
            table = self.node_table
            table.bulk_set_usage(
                touched,
                table.cpu_used[touched] + agg[0][touched],
                table.mem_used[touched] + agg[1][touched],
                table.disk_used[touched] + agg[2][touched],
            )
            self._seed_alloc_count += int(alloc_count)
            return self._bump("allocs")

    def seeded_alloc_count(self) -> int:
        """How many synthetic allocations back the ballast columns."""
        return self._seed_alloc_count

    def delete_node(self, node_id: str) -> int:
        with self._lock:
            if node_id in self.nodes:
                # a freed row can be reused by a future join; it must
                # not inherit this node's seeded allocation ballast
                if self._seed_usage is not None:
                    row = self.node_table.row_of.get(node_id)
                    if row is not None and row < len(
                        self._seed_usage[0]
                    ):
                        for base in self._seed_usage:
                            base[row] = 0.0
                del self.nodes[node_id]
                self.node_table.delete_node(node_id)
                self._readiness_gen += 1
                # prune the conflict-ledger entry so churned node ids
                # don't accumulate forever; the readiness bump above
                # already conflicts any in-flight replay wave, so the
                # count reset can't mask a mid-wave delete+re-register
                self._node_touch.pop(node_id, None)
            return self._bump("nodes")

    def update_node_status(
        self, node_id: str, status: str, now: Optional[float] = None
    ) -> int:
        # `now` is stamped by the proposer so a replicated command
        # stream applies identically on every server (FSM determinism)
        with self._lock:
            node = self.nodes.get(node_id)
            if node is None:
                raise KeyError(node_id)
            was_ready = node.ready()
            node.status = status
            node.status_updated_at = time.time() if now is None else now
            node.modify_index = self._index + 1
            self.node_table.upsert_node(node)
            index = self._bump("nodes")
            self._touch_node(node_id)
            if was_ready != node.ready():
                self._readiness_gen += 1
            return index

    def update_node_statuses(
        self,
        node_ids,
        status: str,
        now: Optional[float] = None,
        message: str = "",
    ) -> int:
        """One batched status transition for a whole wave of nodes —
        the mass node-death path.  ONE lock acquisition and ONE index
        bump cover every member (a 500-node rack death is one FSM
        apply, not 500 serialized writes under the lock), and the
        optional ``message`` lands as one NodeEvent per member inside
        the same critical section.  Unknown node ids are skipped (a
        purge racing the sweep must not fail the wave).  ``now`` is
        stamped by the proposer (FSM determinism, like
        update_node_status)."""
        from ..structs import NodeEvent

        stamp = time.time() if now is None else now
        with self._lock:
            readiness_flips = 0
            touched = False
            for node_id in node_ids:
                node = self.nodes.get(node_id)
                if node is None:
                    continue
                touched = True
                was_ready = node.ready()
                node.status = status
                node.status_updated_at = stamp
                node.modify_index = self._index + 1
                self.node_table.upsert_node(node)
                self._touch_node(node_id)
                if was_ready != node.ready():
                    readiness_flips += 1
                if message:
                    ev = NodeEvent(
                        message=message, subsystem="Cluster"
                    )
                    ev.create_index = self._index + 1
                    node.add_event(ev)
            if readiness_flips:
                self._readiness_gen += 1
            if not touched:
                return self._index
            return self._bump("nodes")

    def update_node_eligibility(self, node_id: str, eligibility: str) -> int:
        with self._lock:
            node = self.nodes.get(node_id)
            if node is None:
                raise KeyError(node_id)
            was_ready = node.ready()
            node.scheduling_eligibility = eligibility
            node.modify_index = self._index + 1
            self.node_table.upsert_node(node)
            index = self._bump("nodes")
            self._touch_node(node_id)
            if was_ready != node.ready():
                self._readiness_gen += 1
            return index

    def update_node_drain(
        self, node_id: str, drain: bool, strategy=None
    ) -> int:
        with self._lock:
            node = self.nodes.get(node_id)
            if node is None:
                raise KeyError(node_id)
            node.drain = drain
            node.drain_strategy = strategy
            from ..structs import NODE_SCHED_ELIGIBLE, NODE_SCHED_INELIGIBLE

            node.scheduling_eligibility = (
                NODE_SCHED_INELIGIBLE if drain else NODE_SCHED_ELIGIBLE
            )
            node.modify_index = self._index + 1
            self.node_table.upsert_node(node)
            index = self._bump("nodes")
            self._touch_node(node_id)
            self._readiness_gen += 1
            return index

    def upsert_node_events(self, node_id: str, events) -> int:
        """Append to a node's bounded event history (reference
        state_store.go UpsertNodeEvents, fsm.go:247
        UpsertNodeEventsType)."""
        with self._lock:
            node = self.nodes.get(node_id)
            if node is None:
                raise KeyError(node_id)
            for ev in events:
                ev.create_index = self._index + 1
                node.add_event(ev)
            node.modify_index = self._index + 1
            return self._bump("nodes")

    def node_by_id(self, node_id: str) -> Optional[Node]:
        return self.nodes.get(node_id)

    def iter_nodes(self) -> Iterable[Node]:
        return list(self.nodes.values())

    # ------------------------------------------------------------------
    # jobs
    # ------------------------------------------------------------------

    def upsert_job(self, job: Job, keep_versions: int = 6) -> int:
        with self._lock:
            key = (job.namespace, job.id)
            existing = self.jobs.get(key)
            if existing is not None:
                job.create_index = existing.create_index
                job.version = existing.version + 1
            else:
                job.create_index = self._index + 1
                job.version = 0
            job.modify_index = self._index + 1
            job.job_modify_index = self._index + 1
            if job.status not in (JOB_STATUS_DEAD,):
                job.status = JOB_STATUS_PENDING
            self.jobs[key] = job
            versions = self.job_versions[key]
            versions.insert(0, job)
            del versions[keep_versions:]
            self._sync_scaling_policies(job)
            return self._bump("jobs")

    def delete_job(self, namespace: str, job_id: str) -> int:
        with self._lock:
            key = (namespace, job_id)
            self.jobs.pop(key, None)
            self.job_versions.pop(key, None)
            self._drop_scaling_policies(namespace, job_id)
            self.scaling_events.pop(key, None)
            return self._bump("jobs")

    def job_by_id(self, namespace: str, job_id: str) -> Optional[Job]:
        return self.jobs.get((namespace, job_id))

    def job_by_version(
        self, namespace: str, job_id: str, version: int
    ) -> Optional[Job]:
        for j in self.job_versions.get((namespace, job_id), []):
            if j.version == version:
                return j
        return None

    def versions_of_job(
        self, namespace: str, job_id: str
    ) -> List[Job]:
        """All retained versions, newest first (reference
        state_store.go JobVersionsByID)."""
        return list(self.job_versions.get((namespace, job_id), []))

    def set_job_stability(
        self, namespace: str, job_id: str, version: int, stable: bool
    ) -> int:
        """(reference state_store.go UpdateJobStability)"""
        with self._lock:
            job = self.job_by_version(namespace, job_id, version)
            if job is None:
                raise KeyError(f"job {job_id!r} version {version}")
            job.stable = stable
            return self._bump("jobs")

    def iter_jobs(self) -> Iterable[Job]:
        return list(self.jobs.values())

    # ------------------------------------------------------------------
    # scaling policies + events (reference state_store.go
    # UpsertScalingPolicies / UpsertScalingEvent; policies live/die with
    # their job, nomad/state/state_store.go job upsert path)
    # ------------------------------------------------------------------

    def _sync_scaling_policies(self, job: Job) -> None:
        """Derive scaling policies from the job's task-group scaling
        stanzas.  Policy ids are stable across job versions: an update
        to a group keeps the policy id keyed by (ns, job, group)."""
        live_targets = set()
        for tg in job.task_groups:
            pol = getattr(tg, "scaling", None)
            if pol is None:
                continue
            pol.canonicalize_for(job, tg.name)
            target = pol.target_tuple()
            live_targets.add(target)
            existing_id = self._scaling_by_target.get(target)
            if existing_id is not None:
                pol.id = existing_id
                pol.create_index = self.scaling_policies[
                    existing_id
                ].create_index
            else:
                pol.create_index = self._index + 1
            pol.modify_index = self._index + 1
            self.scaling_policies[pol.id] = pol
            self._scaling_by_target[target] = pol.id
        # drop policies for groups removed from the job
        for target, pid in list(self._scaling_by_target.items()):
            ns, jid, _group = target
            if (ns, jid) == (job.namespace, job.id) and (
                target not in live_targets
            ):
                del self._scaling_by_target[target]
                self.scaling_policies.pop(pid, None)

    def _drop_scaling_policies(self, namespace: str, job_id: str) -> None:
        for target, pid in list(self._scaling_by_target.items()):
            if (target[0], target[1]) == (namespace, job_id):
                del self._scaling_by_target[target]
                self.scaling_policies.pop(pid, None)

    def scaling_policy_by_id(self, policy_id: str) -> Optional[ScalingPolicy]:
        return self.scaling_policies.get(policy_id)

    def scaling_policy_by_target(
        self, namespace: str, job_id: str, group: str
    ) -> Optional[ScalingPolicy]:
        pid = self._scaling_by_target.get((namespace, job_id, group))
        return self.scaling_policies.get(pid) if pid else None

    def iter_scaling_policies(
        self, namespace: Optional[str] = None, job_id: Optional[str] = None
    ) -> List[ScalingPolicy]:
        out = []
        for pol in self.scaling_policies.values():
            ns, jid, _ = pol.target_tuple()
            if namespace is not None and ns != namespace:
                continue
            if job_id is not None and jid != job_id:
                continue
            out.append(pol)
        return out

    def upsert_scaling_event(
        self, namespace: str, job_id: str, group: str, event: ScalingEvent
    ) -> int:
        with self._lock:
            event.create_index = self._index + 1
            events = self.scaling_events[(namespace, job_id)].setdefault(
                group, []
            )
            events.insert(0, event)
            del events[JOB_TRACKED_SCALING_EVENTS:]
            return self._bump("scaling_event")

    def scaling_events_for_job(
        self, namespace: str, job_id: str
    ) -> Dict[str, List[ScalingEvent]]:
        return {
            g: list(evs)
            for g, evs in self.scaling_events.get(
                (namespace, job_id), {}
            ).items()
        }

    # ------------------------------------------------------------------
    # CSI volumes (reference state_store.go CSIVolumeRegister/
    # CSIVolumeClaim/CSIVolumeDeregister; plugin health is a derived
    # view over node fingerprints)
    # ------------------------------------------------------------------

    # ------------------------------------------------------------------
    # namespaces (reference state_store.go UpsertNamespaces/
    # DeleteNamespaces; table nomad/state/schema.go)
    # ------------------------------------------------------------------

    def upsert_namespace(self, ns: Namespace) -> int:
        ns.validate()
        with self._lock:
            existing = self.namespaces.get(ns.name)
            if existing is None:
                ns.create_index = self._index + 1
            else:
                ns.create_index = existing.create_index
            ns.modify_index = self._index + 1
            self.namespaces[ns.name] = ns
            return self._bump("namespaces")

    def delete_namespace(self, name: str) -> int:
        with self._lock:
            if name == "default":
                raise ValueError(
                    "default namespace can not be deleted"
                )
            if name not in self.namespaces:
                raise KeyError(f"namespace {name!r} does not exist")
            # non-empty namespaces refuse deletion (reference
            # nomad/state namespace deletion checks jobs + volumes)
            jobs = [j for (n, _), j in self.jobs.items() if n == name]
            vols = [
                v for (n, _), v in self.csi_volumes.items() if n == name
            ]
            if jobs or vols:
                raise ValueError(
                    f"namespace {name!r} has {len(jobs)} jobs and "
                    f"{len(vols)} volumes; delete them first"
                )
            del self.namespaces[name]
            return self._bump("namespaces")

    def reconcile_job_summaries(self) -> int:
        """Recompute every job's derived status under the lock
        (reference nomad/system_endpoint.go ReconcileJobSummaries →
        raft ReconcileJobSummariesRequestType); bumps the jobs index so
        blocking queries wake."""
        with self._lock:
            for (ns, job_id), job in self.jobs.items():
                job.status = self.derive_job_status(ns, job_id)
            return self._bump("jobs")

    def namespace_by_name(self, name: str) -> Optional[Namespace]:
        return self.namespaces.get(name)

    def iter_namespaces(self) -> List[Namespace]:
        with self._lock:
            return sorted(
                self.namespaces.values(), key=lambda n: n.name
            )

    def upsert_csi_volume(self, volume: CSIVolume) -> int:
        with self._lock:
            key = (volume.namespace, volume.id)
            existing = self.csi_volumes.get(key)
            if existing is not None:
                volume.create_index = existing.create_index
                # claims survive a re-register (reference: volume
                # updates cannot drop live claims)
                volume.read_claims = dict(existing.read_claims)
                volume.write_claims = dict(existing.write_claims)
            else:
                volume.create_index = self._index + 1
            volume.modify_index = self._index + 1
            self.csi_volumes[key] = volume
            return self._bump("csi_volumes")

    def deregister_csi_volume(
        self, namespace: str, volume_id: str, force: bool = False
    ) -> int:
        with self._lock:
            vol = self.csi_volumes.get((namespace, volume_id))
            if vol is None:
                raise KeyError(f"volume {volume_id!r} not found")
            if vol.in_use() and not force:
                raise ValueError(
                    f"volume {volume_id!r} has active claims"
                )
            del self.csi_volumes[(namespace, volume_id)]
            return self._bump("csi_volumes")

    def csi_volume_by_id(
        self, namespace: str, volume_id: str
    ) -> Optional[CSIVolume]:
        return self.csi_volumes.get((namespace, volume_id))

    def iter_csi_volumes(
        self, namespace: Optional[str] = None
    ) -> List[CSIVolume]:
        return [
            v
            for v in self.csi_volumes.values()
            if namespace is None or v.namespace == namespace
        ]

    def claim_csi_volume(
        self,
        namespace: str,
        volume_id: str,
        alloc_id: str,
        node_id: str,
        read_only: bool,
    ) -> int:
        with self._lock:
            vol = self.csi_volumes.get((namespace, volume_id))
            if vol is None:
                raise KeyError(f"volume {volume_id!r} not found")
            if alloc_id not in vol.read_claims and (
                alloc_id not in vol.write_claims
            ):
                if not vol.claimable(read_only):
                    raise ValueError(
                        f"volume {volume_id!r} is not claimable "
                        f"({vol.access_mode})"
                    )
                vol.claim(alloc_id, node_id, read_only)
            vol.modify_index = self._index + 1
            return self._bump("csi_volumes")

    def detach_csi_volume(
        self, namespace: str, volume_id: str, node_id: str
    ) -> int:
        """Drop every claim a node holds on one volume (reference
        csi_endpoint.go Unpublish backing `volume detach`).  Returns
        the number of claims released."""
        with self._lock:
            vol = self.csi_volumes.get((namespace, volume_id))
            if vol is None:
                raise KeyError(f"volume {volume_id!r} not found")
            released = 0
            for claims in (vol.read_claims, vol.write_claims):
                for alloc_id, claim_node in list(claims.items()):
                    if claim_node == node_id:
                        del claims[alloc_id]
                        released += 1
            if released:
                vol.modify_index = self._index + 1
                self._bump("csi_volumes")
            return released

    def release_csi_claims_for_alloc(self, alloc_id: str) -> Optional[int]:
        """Drop every claim held by one alloc (the volume watcher's
        write path, reference volumewatcher/volumes_watcher.go)."""
        with self._lock:
            hit = False
            for vol in self.csi_volumes.values():
                if vol.release(alloc_id):
                    vol.modify_index = self._index + 1
                    hit = True
            if not hit:
                return None
            return self._bump("csi_volumes")

    def csi_plugins(self) -> Dict[str, CSIPlugin]:
        """Aggregate per-plugin health from node fingerprints."""
        with self._lock:
            plugins: Dict[str, CSIPlugin] = {}
            for node in self.nodes.values():
                for pid, healthy in node.csi_node_plugins.items():
                    p = plugins.setdefault(pid, CSIPlugin(id=pid))
                    p.nodes_expected += 1
                    if healthy:
                        p.nodes_healthy += 1
                        p.node_ids.append(node.id)
            return plugins

    # ------------------------------------------------------------------
    # evals
    # ------------------------------------------------------------------

    def upsert_evals(
        self, evals: List[Evaluation], now: Optional[float] = None
    ) -> int:
        if now is None:
            now = time.time()
        with self._lock:
            for ev in evals:
                existing = self.evals.get(ev.id)
                if existing is not None:
                    ev.create_index = existing.create_index
                else:
                    ev.create_index = self._index + 1
                ev.modify_index = self._index + 1
                ev.modify_time = now
                self.evals[ev.id] = ev
                self._evals_by_job[(ev.namespace, ev.job_id)].add(ev.id)
            return self._bump("evals")

    def delete_eval(self, eval_id: str) -> None:
        with self._lock:
            ev = self.evals.pop(eval_id, None)
            if ev is not None:
                self._evals_by_job[(ev.namespace, ev.job_id)].discard(eval_id)
            self._bump("evals")

    def eval_by_id(self, eval_id: str) -> Optional[Evaluation]:
        return self.evals.get(eval_id)

    def evals_by_job(self, namespace: str, job_id: str) -> List[Evaluation]:
        return [
            self.evals[eid]
            for eid in self._evals_by_job.get((namespace, job_id), ())
            if eid in self.evals
        ]

    # ------------------------------------------------------------------
    # allocs
    # ------------------------------------------------------------------

    def upsert_allocs(self, allocs: List[Allocation]) -> int:
        with self._lock:
            self._upsert_allocs_locked(allocs)
            index = self._bump("allocs")
            self._notify_alloc_watchers(allocs)
            return index

    def _notify_alloc_watchers(self, allocs: List[Allocation]) -> None:
        """Called under self._lock so concurrent writers deliver deltas
        in commit order (out-of-order delivery would let a stale live
        version of an alloc overwrite its terminal update in the
        catalog).  Callbacks must only use the store's lock-free read
        surface.  ``allocs=None`` signals a wholesale table replacement
        (snapshot restore)."""
        if allocs or allocs is None:
            for cb in self._alloc_watchers:
                cb(allocs)

    def _upsert_allocs_locked(self, allocs: List[Allocation]) -> None:
        for alloc in allocs:
            existing = self.allocs.get(alloc.id)
            if existing is not None:
                alloc.create_index = existing.create_index
                # preserve the job from the existing alloc if absent
                if alloc.job is None:
                    alloc.job = existing.job
                was_live = not existing.terminal_status()
            else:
                alloc.create_index = self._index + 1
                was_live = False
            alloc.modify_index = self._index + 1
            self.allocs[alloc.id] = alloc
            # conflict ledger: any alloc write mutates its node's
            # schedulable state (usage, ports, devices, proposed set)
            self._touch_node(alloc.node_id)
            self._allocs_by_node[alloc.node_id].add(alloc.id)
            self._allocs_by_job[(alloc.namespace, alloc.job_id)].add(alloc.id)
            if alloc.eval_id:
                self._allocs_by_eval[alloc.eval_id].add(alloc.id)
            is_live = not alloc.terminal_status()
            # existing is alloc: an aliasing caller mutated the stored
            # object in place, so was_live is unknowable — recompute
            # usage unconditionally rather than miss a live->terminal
            if was_live != is_live or existing is None or existing is alloc:
                self.node_table.update_node_usage(
                    alloc.node_id, self._live_usage_for_node(alloc.node_id)
                )
            # port occupancy follows the same lifecycle, but also
            # shifts when an update re-offers ports on the same node
            self._refresh_port_index(alloc.node_id)

    def _live_usage_for_node(self, node_id: str):
        cpu = mem = disk = 0
        if self._seed_usage is not None:
            row = self.node_table.row_of.get(node_id)
            if row is not None and row < len(self._seed_usage[0]):
                cpu = int(self._seed_usage[0][row])
                mem = int(self._seed_usage[1][row])
                disk = int(self._seed_usage[2][row])
        for aid in self._allocs_by_node.get(node_id, ()):
            a = self.allocs[aid]
            if a.terminal_status():
                continue
            c = a.comparable_resources()
            cpu += c.cpu
            mem += c.memory_mb
            disk += c.disk_mb
        return cpu, mem, disk

    def _refresh_port_index(self, node_id: str) -> None:
        """Per-node recount of live allocated static host ports, from
        both group-level offers (shared.ports) and task-level network
        offers (tasks[*].networks — rank.py assign_network stores them
        there, never in shared.ports).  Keyed port -> {node_id: count}
        so the batch prescorer can build per-port occupancy columns
        without scanning the whole alloc set (reference builds a
        NetworkIndex per candidate node lazily — rank.go network
        path; the kernel needs all nodes up front).  Dynamic-range
        ports are skipped: static asks in that range are gated to the
        sequential path, so the index is never queried for them."""
        from ..structs.network import MIN_DYNAMIC_PORT

        for port in self._ports_by_node.pop(node_id, ()):
            nodes = self._ports_live.get(port)
            if nodes is not None:
                nodes.pop(node_id, None)
                if not nodes:
                    del self._ports_live[port]
        # device reservations live in ONE index — the node table's
        # device_used, read by the per-select mask (MaskCompiler.
        # device_feasibility / device_count_columns) and the batch
        # kernel's free columns alike
        row = self.node_table.row_of.get(node_id)
        if row is not None:
            for key in [
                k for k in self.node_table.device_used
                if k[0] == row
            ]:
                del self.node_table.device_used[key]
        held: set = set()
        for aid in self._allocs_by_node.get(node_id, ()):
            a = self.allocs[aid]
            if a.terminal_status() or a.allocated_resources is None:
                continue
            values = [
                p.value
                for p in a.allocated_resources.shared.ports
            ]
            for tr in a.allocated_resources.tasks.values():
                for net in tr.networks:
                    values.extend(
                        p.value for p in net.reserved_ports
                    )
                if row is not None:
                    for dv in tr.devices:
                        key = (
                            row,
                            (dv.vendor, dv.type, dv.name),
                        )
                        self.node_table.device_used[key] = (
                            self.node_table.device_used.get(key, 0)
                            + len(dv.device_ids)
                        )
            for value in values:
                if not value or value >= MIN_DYNAMIC_PORT:
                    continue
                by_node = self._ports_live.setdefault(value, {})
                by_node[node_id] = by_node.get(node_id, 0) + 1
                held.add(value)
        if held:
            self._ports_by_node[node_id] = held

    def live_port_nodes(self, port: int) -> Dict[str, int]:
        """node_id -> live alloc count holding `port` (empty when
        free everywhere)."""
        return self._ports_live.get(port, {})

    def usage_delta_since(
        self, generation: int
    ) -> Tuple[int, List[int]]:
        """Atomic (current usage generation, rows dirtied after
        ``generation``) for consumers that mirror the node table's
        usage columns off-host (the BatchWorker's device-resident
        input cache).  Taken under the store lock so a concurrent plan
        apply can't dirty a row between the generation read and the
        row scan — a racing write after release only makes the row
        dirty again at a later generation, so the next delta re-patches
        it with the same values (idempotent)."""
        with self._lock:
            table = self.node_table
            return (
                table.usage_generation,
                table.usage_rows_dirty_since(generation),
            )

    def _touch_node(self, node_id: str) -> None:
        """Bump a node's mutation fingerprint (called under the store
        lock by every write that changes the node's schedulable
        state)."""
        self._node_touch[node_id] = self._node_touch.get(node_id, 0) + 1

    def node_touch_count(self, node_id: str) -> int:
        """Current mutation-fingerprint count for one node.
        Lock-free: counts are ints assigned under the store lock, and
        a racing write only makes a conflict check more
        conservative."""
        return self._node_touch.get(node_id, 0)

    def node_touch_counts(self) -> Dict[str, int]:
        """Snapshot of every node's mutation count (the optimistic
        replay wave's conflict baseline), copied under the lock so it
        is consistent with a single store index."""
        with self._lock:
            return dict(self._node_touch)

    def readiness_generation(self) -> int:
        """Generation of the ready-node set (bumped on join/leave and
        status/eligibility/drain flips, NOT on usage churn) — the
        global fence for speculative replays whose candidate scan
        covers every node."""
        return self._readiness_gen

    def alloc_by_id(self, alloc_id: str) -> Optional[Allocation]:
        return self.allocs.get(alloc_id)

    def allocs_by_node(self, node_id: str) -> List[Allocation]:
        return [
            self.allocs[aid]
            for aid in self._allocs_by_node.get(node_id, ())
            if aid in self.allocs
        ]

    def allocs_by_node_terminal(
        self, node_id: str, terminal: bool
    ) -> List[Allocation]:
        return [
            a for a in self.allocs_by_node(node_id) if a.terminal_status() == terminal
        ]

    def allocs_by_job(
        self, namespace: str, job_id: str, all_versions: bool = True
    ) -> List[Allocation]:
        return [
            self.allocs[aid]
            for aid in self._allocs_by_job.get((namespace, job_id), ())
            if aid in self.allocs
        ]

    def allocs_by_eval(self, eval_id: str) -> List[Allocation]:
        return [
            self.allocs[aid]
            for aid in self._allocs_by_eval.get(eval_id, ())
            if aid in self.allocs
        ]

    # ------------------------------------------------------------------
    # deployments
    # ------------------------------------------------------------------

    def upsert_deployment(self, deployment: Deployment) -> int:
        with self._lock:
            existing = self.deployments.get(deployment.id)
            if existing is not None:
                deployment.create_index = existing.create_index
            else:
                deployment.create_index = self._index + 1
            deployment.modify_index = self._index + 1
            self.deployments[deployment.id] = deployment
            self._deployments_by_job[
                (deployment.namespace, deployment.job_id)
            ].add(deployment.id)
            return self._bump("deployments")

    def deployment_by_id(self, deployment_id: str) -> Optional[Deployment]:
        return self.deployments.get(deployment_id)

    def deployments_by_job(
        self, namespace: str, job_id: str
    ) -> List[Deployment]:
        return [
            self.deployments[did]
            for did in self._deployments_by_job.get((namespace, job_id), ())
            if did in self.deployments
        ]

    def latest_deployment_by_job(
        self, namespace: str, job_id: str
    ) -> Optional[Deployment]:
        deployments = self.deployments_by_job(namespace, job_id)
        if not deployments:
            return None
        return max(deployments, key=lambda d: d.create_index)

    # ------------------------------------------------------------------
    # scheduler config
    # ------------------------------------------------------------------

    def get_autopilot_config(self):
        return self.autopilot_config

    def set_autopilot_config(self, config) -> int:
        """(reference state_store.go AutopilotSetConfig; operator
        endpoint writes it through raft)"""
        with self._lock:
            self.autopilot_config = config
            return self._bump("autopilot-config")

    def get_scheduler_config(self) -> SchedulerConfiguration:
        return self.scheduler_config

    def set_scheduler_config(self, config: SchedulerConfiguration) -> int:
        with self._lock:
            self.scheduler_config = config
            return self._bump("scheduler_config")

    # ------------------------------------------------------------------
    # plan results -- the one write path for the scheduler
    # (reference state_store.go:240 UpsertPlanResults)
    # ------------------------------------------------------------------

    def upsert_plan_results(
        self, result: PlanResult, eval_id: str = "",
        leader_gen: Optional[int] = None,
    ) -> int:
        # leader_gen is the replicated-store facade's concern (the FSM
        # leadership fence); the direct single-process store accepts
        # and ignores it so the plan applier can pass one call shape
        with self._lock:
            updates: List[Allocation] = []
            for allocs in result.node_update.values():
                updates.extend(allocs)
            for allocs in result.node_preemptions.values():
                updates.extend(allocs)
            for allocs in result.node_allocation.values():
                updates.extend(allocs)
            self._upsert_allocs_locked(updates)
            # claim CSI volumes for the placements in this plan (the
            # serialized applier is the claim's linearization point;
            # reference claims via CSIVolume.Claim from the client's
            # csi_hook, released by the volume watcher either way)
            for allocs in result.node_allocation.values():
                for alloc in allocs:
                    self._claim_csi_for_alloc_locked(alloc)
            if result.deployment is not None:
                d = result.deployment
                existing = self.deployments.get(d.id)
                if existing is None:
                    d.create_index = self._index + 1
                d.modify_index = self._index + 1
                self.deployments[d.id] = d
                self._deployments_by_job[(d.namespace, d.job_id)].add(d.id)
            for upd in result.deployment_updates:
                d = self.deployments.get(upd.deployment_id)
                if d is not None:
                    d.status = upd.status
                    d.status_description = upd.status_description
                    d.modify_index = self._index + 1
            # record canary placements on the deployment state so later
            # reconcile passes (watcher evals, re-registers) recognize
            # them instead of double-placing canaries / stopping old
            # allocs (reference state_store.go updateDeploymentWithAlloc
            # appending to DeploymentState.PlacedCanaries)
            for allocs in result.node_allocation.values():
                for alloc in allocs:
                    if not (
                        alloc.deployment_id
                        and alloc.deployment_status is not None
                        and alloc.deployment_status.canary
                    ):
                        continue
                    d = self.deployments.get(alloc.deployment_id)
                    if d is None:
                        continue
                    ds = d.task_groups.get(alloc.task_group)
                    if ds is not None and (
                        alloc.id not in ds.placed_canaries
                    ):
                        ds.placed_canaries.append(alloc.id)
            index = self._bump("allocs", "deployments")
            self._notify_alloc_watchers(updates)
            if eval_id:
                # flight recorder: the eval's plan reached durable
                # state at this raft index — the trace's commit mark
                TRACE.event(
                    eval_id, "store.commit", index=index,
                    allocs=len(updates),
                )
            return index

    def _claim_csi_for_alloc_locked(self, alloc: Allocation) -> None:
        job = alloc.job or self.job_by_id(alloc.namespace, alloc.job_id)
        if job is None:
            return
        tg = job.lookup_task_group(alloc.task_group)
        if tg is None:
            return
        for req in tg.volumes.values():
            if req.type != "csi":
                continue
            vol = self.csi_volumes.get((alloc.namespace, req.source))
            if vol is None:
                continue
            if alloc.id in vol.read_claims or alloc.id in vol.write_claims:
                continue
            if vol.claimable(req.read_only):
                vol.claim(alloc.id, alloc.node_id, req.read_only)
                vol.modify_index = self._index + 1

    # ------------------------------------------------------------------
    # job status derivation (reference state_store.go setJobStatus)
    # ------------------------------------------------------------------

    def derive_job_status(self, namespace: str, job_id: str) -> str:
        job = self.job_by_id(namespace, job_id)
        if job is None:
            return JOB_STATUS_DEAD
        allocs = self.allocs_by_job(namespace, job_id)
        evals = self.evals_by_job(namespace, job_id)
        if any(not a.terminal_status() for a in allocs):
            return JOB_STATUS_RUNNING
        if any(not e.terminal_status() for e in evals):
            return JOB_STATUS_PENDING
        if job.stop:
            return JOB_STATUS_DEAD
        if job.type == JOB_TYPE_SYSTEM or job.is_periodic() or job.is_parameterized():
            return JOB_STATUS_RUNNING if not job.stop else JOB_STATUS_DEAD
        if allocs or evals:
            return JOB_STATUS_DEAD
        return JOB_STATUS_PENDING


class StateSnapshot:
    """A read view fenced at an index.

    Mutation is serialized behind the plan applier in this control plane, so
    the snapshot can delegate to the live store; it exists to carry the
    snapshot index (for plan verification ordering) and to present the small
    `State` read surface the schedulers consume
    (reference scheduler/scheduler.go:65-109).
    """

    def __init__(self, store: StateStore, index: int) -> None:
        self._store = store
        self.index = index
        self._job_override: Optional[Job] = None

    def override_job(self, job: Job) -> None:
        """Overlay a not-yet-committed job version on this view (used
        by the plan dry-run so staging never touches the store —
        reference nomad/job_endpoint.go Plan runs on a snapshot)."""
        self._job_override = job

    def latest_index(self) -> int:
        """The snapshot's fence index — lets store consumers that
        only need the read surface plus an index (plan_apply's
        evaluate_plan stamping refresh_index) accept a snapshot."""
        return self.index

    # the scheduler-facing read surface
    def nodes(self) -> List[Node]:
        return list(self._store.iter_nodes())

    def node_by_id(self, node_id: str) -> Optional[Node]:
        return self._store.node_by_id(node_id)

    def job_by_id(self, namespace: str, job_id: str) -> Optional[Job]:
        ov = self._job_override
        if ov is not None and (ov.namespace, ov.id) == (namespace, job_id):
            return ov
        return self._store.job_by_id(namespace, job_id)

    def job_by_version(self, namespace: str, job_id: str, version: int):
        return self._store.job_by_version(namespace, job_id, version)

    def allocs_by_job(self, namespace: str, job_id: str) -> List[Allocation]:
        return self._store.allocs_by_job(namespace, job_id)

    def allocs_by_node(self, node_id: str) -> List[Allocation]:
        return self._store.allocs_by_node(node_id)

    def allocs_by_node_terminal(self, node_id: str, terminal: bool):
        return self._store.allocs_by_node_terminal(node_id, terminal)

    def live_port_nodes(self, port: int) -> Dict[str, int]:
        return self._store.live_port_nodes(port)

    def node_touch_count(self, node_id: str) -> int:
        return self._store.node_touch_count(node_id)

    def readiness_generation(self) -> int:
        return self._store.readiness_generation()

    def alloc_by_id(self, alloc_id: str) -> Optional[Allocation]:
        return self._store.alloc_by_id(alloc_id)

    def eval_by_id(self, eval_id: str) -> Optional[Evaluation]:
        return self._store.eval_by_id(eval_id)

    def evals_by_job(self, namespace: str, job_id: str) -> List[Evaluation]:
        return self._store.evals_by_job(namespace, job_id)

    def deployments_by_job(self, namespace: str, job_id: str):
        return self._store.deployments_by_job(namespace, job_id)

    def latest_deployment_by_job(self, namespace: str, job_id: str):
        return self._store.latest_deployment_by_job(namespace, job_id)

    def scheduler_config(self) -> SchedulerConfiguration:
        return self._store.get_scheduler_config()

    def csi_volume_by_id(
        self, namespace: str, volume_id: str
    ) -> Optional[CSIVolume]:
        return self._store.csi_volume_by_id(namespace, volume_id)

    def iter_csi_volumes(
        self, namespace: Optional[str] = None
    ) -> List[CSIVolume]:
        return self._store.iter_csi_volumes(namespace)

    @property
    def node_table(self) -> NodeTable:
        return self._store.node_table
