"""Columnar mirror of the node table: the TPU-resident "cluster tensor".

This is the structure the whole TPU-first design hangs off (SURVEY.md
section 7.1): every scheduling-relevant node property is kept as a flat
numpy column over a padded row space, so one `jax.jit`-ed kernel can score
*all* candidate nodes at once instead of walking them through the
reference's pull-based iterator chain (scheduler/stack.go:116).

Key ideas:

* **Stable padded capacity.**  Rows live in a fixed-capacity arena that
  grows by doubling, so jit traces stay cached across node joins/leaves;
  vacant rows are simply masked out via the ``active`` column.

* **String interning.**  Node attributes are strings in the reference
  (`Node.Attributes``/``Meta``, feasible.go:713 resolveTarget).  Every
  attribute column interns its values into dense int32 codes (missing =
  -1).  A constraint over any operator — including regex, version and
  semver, the reference's "escaped" cases (feasible.go:776) — compiles to
  a boolean lookup table over the column's (small) vocabulary, evaluated
  host-side with exact reference semantics; on device the check is just
  ``lut[codes]``, a vectorized gather.  This is how *all* constraint
  operators become TPU-friendly without shipping strings to the chip.

* **Incremental usage columns.**  Live cpu/mem/disk usage per node is
  maintained by the state store on alloc transitions, so per-eval scoring
  needs only the (plan-local) delta, mirroring how the reference derives
  `ProposedAllocs` from a snapshot plus the in-flight plan
  (scheduler/context.go:120).
"""
from __future__ import annotations

import itertools
from bisect import bisect_right
from typing import Dict, List, Optional, Sequence, Tuple, TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:  # pragma: no cover
    from ..structs import Node

MISSING = -1
MIN_CAPACITY = 64


class Interner:
    """Dense string -> int32 code assignment, append-only."""

    def __init__(self) -> None:
        self._codes: Dict[str, int] = {}
        self.values: List[str] = []

    def code(self, value: str) -> int:
        c = self._codes.get(value)
        if c is None:
            c = len(self.values)
            self._codes[value] = c
            self.values.append(value)
        return c

    def lookup(self, value: str) -> int:
        return self._codes.get(value, MISSING)

    def __len__(self) -> int:
        return len(self.values)


class _Column:
    """An interned string column over the node arena."""

    def __init__(self, capacity: int) -> None:
        self.codes = np.full(capacity, MISSING, dtype=np.int32)
        self.interner = Interner()

    def grow(self, capacity: int) -> None:
        new = np.full(capacity, MISSING, dtype=np.int32)
        new[: len(self.codes)] = self.codes
        self.codes = new


class NodeTable:
    # process-wide instance epoch: a snapshot restore REPLACES the
    # store's table with a fresh one whose generation counters restart,
    # so consumers keying caches on (generation, capacity) alone could
    # collide with pre-restore state — the epoch disambiguates tables
    _epochs = itertools.count()

    def __init__(self, capacity: int = MIN_CAPACITY) -> None:
        self.epoch = next(NodeTable._epochs)
        self.capacity = capacity
        self.n_rows = 0  # high-water mark of used rows
        self.row_of: Dict[str, int] = {}
        self.node_ids: List[Optional[str]] = [None] * capacity
        self._free_rows: List[int] = []

        self.active = np.zeros(capacity, dtype=bool)
        self.eligible = np.zeros(capacity, dtype=bool)
        # totals are node resources minus node-reserved resources, the
        # denominator of the reference's free-percentage score
        # (funcs.go:computeFreePercentage)
        self.cpu_total = np.zeros(capacity, dtype=np.float64)
        self.mem_total = np.zeros(capacity, dtype=np.float64)
        self.disk_total = np.zeros(capacity, dtype=np.float64)
        self.cpu_used = np.zeros(capacity, dtype=np.float64)
        self.mem_used = np.zeros(capacity, dtype=np.float64)
        self.disk_used = np.zeros(capacity, dtype=np.float64)

        # interned string columns, keyed by resolved target namespace:
        #   "node.id", "node.name", "node.datacenter", "node.class",
        #   "node.computed_class", "attr.<key>", "meta.<key>",
        #   "driver.<name>" (value "1" when present+healthy),
        #   "hostvol.<name>" (value "1"/"ro")
        self.columns: Dict[str, _Column] = {}

        # device inventory: per node, list of (group_sig_code, count);
        # group signatures intern (vendor, type, name, attrs) tuples
        self.device_sigs = Interner()
        self.device_groups: Dict[int, List[Tuple[int, int]]] = {}
        self._device_sig_meta: Dict[int, tuple] = {}
        # (node_row, (vendor,type,name)) -> instances used by live allocs
        self.device_used: Dict[Tuple[int, Tuple[str, str, str]], int] = {}

        self.generation = 0  # bumped on any mutation; device cache key
        # bumped only on node join/leave/attribute/eligibility changes —
        # NOT on usage updates — so per-jobspec candidate/mask caches
        # survive plan commits (usage changes every apply; topology
        # changes orders of magnitude less often)
        self.topo_generation = 0
        # usage-delta log: monotone generation bumped on every usage
        # write, plus row -> generation-last-dirtied.  Consumers that
        # mirror the usage columns (the BatchWorker's device-resident
        # input cache) record the generation they synced at and patch
        # only rows dirtied since, instead of re-shipping all C rows
        # per flush.
        #
        # The query must cost O(rows dirtied since), not O(rows ever
        # dirtied): a follower catching up from a short lag over a
        # million-row arena cannot afford a full scan of the dirty map
        # per flush.  So writes append to a generation-ordered log
        # (parallel int lists, gens nondecreasing) that the query
        # bisects; the map keeps only each row's LATEST generation and
        # drives coalescing — whenever the log grows past twice the
        # map, it is rebuilt from the map (one entry per row, sorted by
        # generation).  Coalescing is lossless for every "dirty since
        # g" query: a row dirtied after g has latest-gen > g, and the
        # latest entry is exactly what survives.  Amortized O(1) per
        # write, log length bounded by 2x rows-currently-dirty.
        self.usage_generation = 0
        self._usage_dirty: Dict[int, int] = {}
        self._usage_log_gens: List[int] = []
        self._usage_log_rows: List[int] = []
        # row -> scheduling-relevant fingerprint of the node last
        # upserted there, for topo-change detection (see upsert_node)
        self._row_fingerprints: Dict[int, tuple] = {}

    # ------------------------------------------------------------------
    # arena management
    # ------------------------------------------------------------------

    def _ensure_capacity(self, needed: int) -> None:
        if needed <= self.capacity:
            return
        new_cap = self.capacity
        while new_cap < needed:
            new_cap *= 2
        for name in (
            "active",
            "eligible",
            "cpu_total",
            "mem_total",
            "disk_total",
            "cpu_used",
            "mem_used",
            "disk_used",
        ):
            old = getattr(self, name)
            new = np.zeros(new_cap, dtype=old.dtype)
            new[: self.capacity] = old
            setattr(self, name, new)
        for col in self.columns.values():
            col.grow(new_cap)
        self.node_ids.extend([None] * (new_cap - self.capacity))
        self.capacity = new_cap

    def _alloc_row(self, node_id: str) -> int:
        if self._free_rows:
            row = self._free_rows.pop()
        else:
            self._ensure_capacity(self.n_rows + 1)
            row = self.n_rows
            self.n_rows += 1
        self.row_of[node_id] = row
        self.node_ids[row] = node_id
        return row

    # ------------------------------------------------------------------
    # column access
    # ------------------------------------------------------------------

    def column(self, key: str) -> _Column:
        """Get or lazily create an interned column, backfilling existing
        rows on first touch."""
        col = self.columns.get(key)
        if col is not None:
            return col
        col = _Column(self.capacity)
        self.columns[key] = col
        # backfill from stored nodes
        for node_id, row in self.row_of.items():
            value = self._raw_value(key, row)
            col.codes[row] = (
                col.interner.code(value) if value is not None else MISSING
            )
        self.generation += 1
        return col

    def _raw_value(self, key: str, row: int) -> Optional[str]:
        node = self._nodes_cache.get(self.node_ids[row]) if hasattr(
            self, "_nodes_cache"
        ) else None
        if node is None:
            return None
        return _resolve_column_value(node, key)

    # ------------------------------------------------------------------
    # mutation
    # ------------------------------------------------------------------

    @staticmethod
    def _node_fingerprint(node: "Node", eligible: bool) -> tuple:
        """Everything about a node that any topology-keyed consumer
        can observe (columns — materialized or lazily created later —
        candidate sets, port-reservation columns, device inventory).
        If this tuple is unchanged, re-upserting the node cannot
        change any scheduling decision."""
        res = node.node_resources
        reserved = node.reserved_resources
        return (
            node.name,
            node.datacenter,
            node.node_class,
            node.computed_class,
            eligible,
            float(res.cpu - reserved.cpu),
            float(res.memory_mb - reserved.memory_mb),
            float(res.disk_mb - reserved.disk_mb),
            tuple(sorted(node.attributes.items())),
            tuple(sorted(node.meta.items())),
            tuple(
                sorted(
                    (k, bool(v)) for k, v in node.drivers.items()
                )
            ),
            tuple(
                sorted(
                    (k, v.read_only)
                    for k, v in node.host_volumes.items()
                )
            ),
            tuple(
                sorted(
                    (k, bool(v))
                    for k, v in node.csi_node_plugins.items()
                )
            ),
            tuple(sorted(reserved.reserved_ports)),
            tuple(
                (
                    net.mode or "host",
                    net.ip or "",
                    tuple(
                        sorted(p.value for p in net.reserved_ports)
                    ),
                )
                for net in res.networks
            ),
            tuple(
                (
                    g.vendor,
                    g.type,
                    g.name,
                    tuple(
                        sorted(
                            (k, str(v))
                            for k, v in g.attributes.items()
                        )
                    ),
                    tuple(g.instance_ids),
                )
                for g in res.devices
            ),
        )

    def upsert_node(self, node: "Node") -> int:
        if not hasattr(self, "_nodes_cache"):
            self._nodes_cache: Dict[str, "Node"] = {}
        self._nodes_cache[node.id] = node
        row = self.row_of.get(node.id)
        changed = row is None  # join = topology change by definition
        if row is None:
            row = self._alloc_row(node.id)
        eligible = node.ready()
        # topology change detection: heartbeats and periodic
        # fingerprints re-upsert nodes with UNCHANGED state every few
        # seconds; bumping topo_generation for those would thrash
        # every topology-keyed cache downstream (candidate/mask/port
        # columns, the BatchWorker's device-resident input mirror), so
        # the bump happens only when the node's scheduling-relevant
        # fingerprint actually moves
        fp = self._node_fingerprint(node, eligible)
        changed |= self._row_fingerprints.get(row) != fp
        self._row_fingerprints[row] = fp
        self.active[row] = True
        self.eligible[row] = eligible
        res = node.node_resources
        reserved = node.reserved_resources
        self.cpu_total[row] = float(res.cpu - reserved.cpu)
        self.mem_total[row] = float(res.memory_mb - reserved.memory_mb)
        self.disk_total[row] = float(res.disk_mb - reserved.disk_mb)
        for key, col in self.columns.items():
            value = _resolve_column_value(node, key)
            col.codes[row] = (
                col.interner.code(value) if value is not None else MISSING
            )
        groups: List[Tuple[int, int]] = []
        for g in res.devices:
            sig = (
                g.vendor,
                g.type,
                g.name,
                tuple(sorted((k, str(v)) for k, v in g.attributes.items())),
            )
            code = self.device_sigs.code(repr(sig))
            self._device_sig_meta[code] = sig
            groups.append((code, len(g.instance_ids)))
        if groups or row in self.device_groups:
            self.device_groups[row] = groups
        self.generation += 1
        if changed:
            self.topo_generation += 1
        return row

    def delete_node(self, node_id: str) -> None:
        row = self.row_of.pop(node_id, None)
        if row is None:
            return
        self.active[row] = False
        self.eligible[row] = False
        self.cpu_used[row] = self.mem_used[row] = self.disk_used[row] = 0.0
        self.usage_generation += 1
        self._log_usage_dirty(row)
        self.node_ids[row] = None
        self.device_groups.pop(row, None)
        self._row_fingerprints.pop(row, None)
        # a reused row must not inherit phantom device reservations
        for key in [k for k in self.device_used if k[0] == row]:
            del self.device_used[key]
        if hasattr(self, "_nodes_cache"):
            self._nodes_cache.pop(node_id, None)
        self._free_rows.append(row)
        self.generation += 1
        self.topo_generation += 1

    def update_node_usage(
        self, node_id: str, usage: Tuple[int, int, int]
    ) -> None:
        row = self.row_of.get(node_id)
        if row is None:
            return
        self.cpu_used[row] = float(usage[0])
        self.mem_used[row] = float(usage[1])
        self.disk_used[row] = float(usage[2])
        self.generation += 1
        self.usage_generation += 1
        self._log_usage_dirty(row)

    def _log_usage_dirty(self, row: int) -> None:
        """Record ``row`` as dirtied at the CURRENT usage_generation
        (caller bumps first) and coalesce the log when it outgrows the
        per-row map."""
        self._usage_dirty[row] = self.usage_generation
        self._usage_log_gens.append(self.usage_generation)
        self._usage_log_rows.append(row)
        if (
            len(self._usage_log_gens) > 64
            and len(self._usage_log_gens) > 2 * len(self._usage_dirty)
        ):
            self.compact_usage_log()

    def compact_usage_log(self) -> None:
        """Coalesce the usage-delta log down to one entry per dirty
        row (its latest generation), preserving generation order."""
        items = sorted(self._usage_dirty.items(), key=lambda kv: kv[1])
        self._usage_log_rows = [row for row, _ in items]
        self._usage_log_gens = [g for _, g in items]

    def usage_log_len(self) -> int:
        """Current (possibly uncoalesced) log length — observability
        for the compaction tests and the bigworld accounting."""
        return len(self._usage_log_gens)

    def usage_rows_dirty_since(self, generation: int) -> List[int]:
        """Rows whose usage columns changed after ``generation``, in
        O(log L + rows-dirtied-since) via a bisect on the
        generation-ordered log (duplicates coalesced).  Callers needing
        atomicity against concurrent writers go through
        ``StateStore.usage_delta_since`` (takes the store lock)."""
        i = bisect_right(self._usage_log_gens, generation)
        if i == len(self._usage_log_gens):
            return []
        return list(dict.fromkeys(self._usage_log_rows[i:]))

    # ------------------------------------------------------------------
    # bulk (columnar) registration — the bigworld seeding path
    # ------------------------------------------------------------------

    def bulk_register_nodes(self, nodes: Sequence["Node"]) -> np.ndarray:
        """Register many FRESH nodes in one columnar pass.

        The per-node ``upsert_node`` costs a scheduling fingerprint
        (a ~1KB tuple kept per row for topo-change detection) plus a
        per-call generation bump; at a million rows the fingerprints
        alone are a gigabyte and the column writes dominate seed time.
        This path assigns one contiguous row block, fills the numpy
        columns with sliced writes, and skips the fingerprints
        entirely — a later real ``upsert_node`` of the same id sees a
        fingerprint miss and bumps ``topo_generation``, which is the
        conservative (correct) direction.  Caller guarantees no id is
        already registered.  All new rows are marked usage-dirty under
        a single generation so delta mirrors pick them up.
        """
        n = len(nodes)
        if n == 0:
            return np.zeros(0, dtype=np.int32)
        if not hasattr(self, "_nodes_cache"):
            self._nodes_cache: Dict[str, "Node"] = {}
        self._ensure_capacity(self.n_rows + n)
        start = self.n_rows
        self.n_rows += n
        ids = [node.id for node in nodes]
        self.row_of.update(zip(ids, range(start, start + n)))
        self.node_ids[start : start + n] = ids
        self._nodes_cache.update(zip(ids, nodes))
        self.active[start : start + n] = True
        cpu = np.empty(n, dtype=np.float64)
        mem = np.empty(n, dtype=np.float64)
        disk = np.empty(n, dtype=np.float64)
        elig = np.empty(n, dtype=bool)
        for i, node in enumerate(nodes):
            res = node.node_resources
            reserved = node.reserved_resources
            cpu[i] = res.cpu - reserved.cpu
            mem[i] = res.memory_mb - reserved.memory_mb
            disk[i] = res.disk_mb - reserved.disk_mb
            elig[i] = node.ready()
            if res.devices:
                groups: List[Tuple[int, int]] = []
                for g in res.devices:
                    sig = (
                        g.vendor,
                        g.type,
                        g.name,
                        tuple(
                            sorted(
                                (k, str(v))
                                for k, v in g.attributes.items()
                            )
                        ),
                    )
                    code = self.device_sigs.code(repr(sig))
                    self._device_sig_meta[code] = sig
                    groups.append((code, len(g.instance_ids)))
                self.device_groups[start + i] = groups
        self.eligible[start : start + n] = elig
        self.cpu_total[start : start + n] = cpu
        self.mem_total[start : start + n] = mem
        self.disk_total[start : start + n] = disk
        for key, col in self.columns.items():
            for i, node in enumerate(nodes):
                value = _resolve_column_value(node, key)
                col.codes[start + i] = (
                    col.interner.code(value)
                    if value is not None
                    else MISSING
                )
        self.generation += 1
        self.topo_generation += 1
        self.usage_generation += 1
        g = self.usage_generation
        rows = range(start, start + n)
        self._usage_dirty.update(dict.fromkeys(rows, g))
        self._usage_log_gens.extend([g] * n)
        self._usage_log_rows.extend(rows)
        return np.arange(start, start + n, dtype=np.int32)

    def bulk_set_usage(
        self,
        rows: np.ndarray,
        cpu: np.ndarray,
        mem: np.ndarray,
        disk: np.ndarray,
    ) -> None:
        """Vectorized usage write for many rows under ONE generation —
        the seeding path's counterpart of ``update_node_usage`` (which
        costs a generation bump and a log append per row)."""
        if len(rows) == 0:
            return
        self.cpu_used[rows] = cpu
        self.mem_used[rows] = mem
        self.disk_used[rows] = disk
        self.generation += 1
        self.usage_generation += 1
        g = self.usage_generation
        row_list = np.asarray(rows).tolist()
        self._usage_dirty.update(dict.fromkeys(row_list, g))
        self._usage_log_gens.extend([g] * len(row_list))
        self._usage_log_rows.extend(row_list)
        if (
            len(self._usage_log_gens) > 64
            and len(self._usage_log_gens) > 2 * len(self._usage_dirty)
        ):
            self.compact_usage_log()

    # ------------------------------------------------------------------
    # views
    # ------------------------------------------------------------------

    def rows_for(self, node_ids: List[str]) -> np.ndarray:
        return np.array(
            [self.row_of[nid] for nid in node_ids if nid in self.row_of],
            dtype=np.int32,
        )

    def device_sig_key(self, code: int) -> tuple:
        """(vendor, type, name) of a device-sig code — the key shape
        AllocatedDeviceResource records carry."""
        sig = self._device_sig_meta[code]
        return (sig[0], sig[1], sig[2])

    def device_sig_matches(self, code: int, ask_name: str) -> bool:
        """Whether an interned device-group signature matches a device ask
        of the form type | vendor/type | vendor/type/name."""
        sig = self._device_sig_meta.get(code)
        if sig is None:
            return False
        vendor, type_, name, _attrs = sig
        parts = ask_name.split("/")
        if len(parts) == 1:
            return parts[0] == type_
        if len(parts) == 2:
            return parts[0] == vendor and parts[1] == type_
        return (
            parts[0] == vendor
            and parts[1] == type_
            and "/".join(parts[2:]) == name
        )

    def device_sig_attrs(self, code: int) -> Dict[str, str]:
        sig = self._device_sig_meta.get(code)
        if sig is None:
            return {}
        return dict(sig[3])

    def device_count_columns(self, ask_name: str) -> Tuple[np.ndarray, np.ndarray]:
        """(total_matching, used_matching) instance counts per row for a
        device ask (constraint filtering applied separately via sig LUTs)."""
        total = np.zeros(self.capacity, dtype=np.int32)
        used = np.zeros(self.capacity, dtype=np.int32)
        matching_codes = {
            code
            for code in range(len(self.device_sigs))
            if self.device_sig_matches(code, ask_name)
        }
        for row, groups in self.device_groups.items():
            for code, count in groups:
                if code in matching_codes:
                    total[row] += count
        for (row, key), count in self.device_used.items():
            vendor, type_, name = key
            probe = "/".join(x for x in (vendor, type_, name) if x)
            # conservative: count used instances whose group matches the ask
            for code in matching_codes:
                sig = self._device_sig_meta[code]
                if (sig[0], sig[1], sig[2]) == key:
                    used[row] += count
                    break
        return total, used


def _resolve_column_value(node: "Node", key: str) -> Optional[str]:
    """Resolve a column key to the node's string value; None == missing.
    Mirrors the reference's target interpolation (feasible.go:713
    resolveTarget) plus synthetic driver/hostvol namespaces."""
    if key == "node.id":
        return node.id
    if key == "node.name":
        return node.name
    if key == "node.datacenter":
        return node.datacenter
    if key == "node.class":
        return node.node_class
    if key == "node.computed_class":
        return node.computed_class
    if key.startswith("attr."):
        return node.attributes.get(key[len("attr.") :])
    if key.startswith("meta."):
        return node.meta.get(key[len("meta.") :])
    if key.startswith("driver."):
        name = key[len("driver.") :]
        healthy = node.drivers.get(name)
        if healthy is None:
            # fall back to the detected-driver attribute form the
            # fingerprinter writes (reference feasible.go:430)
            attr = node.attributes.get(f"driver.{name}")
            return "1" if attr not in (None, "", "0", "false") else None
        return "1" if healthy else None
    if key.startswith("hostvol."):
        name = key[len("hostvol.") :]
        vol = node.host_volumes.get(name)
        if vol is None:
            return None
        return "ro" if vol.read_only else "rw"
    if key.startswith("csi."):
        name = key[len("csi.") :]
        healthy = node.csi_node_plugins.get(name)
        return "1" if healthy else None
    if key.startswith("netmode."):
        mode = key[len("netmode.") :]
        for net in node.node_resources.networks:
            if (net.mode or "host") == mode:
                return "1"
        # host mode is implicitly available on every node
        return "1" if mode == "host" else None
    return None
