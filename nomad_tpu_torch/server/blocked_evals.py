"""Blocked evaluations tracker (reference nomad/blocked_evals.go).

Evals that failed placement wait here keyed by computed-class
eligibility; capacity changes (node updates, alloc stops) unblock the
evals that could now succeed.  Escaped evals (constraints outside the
computed-class system) are always re-run.  Deduped per job: a newer
blocked eval replaces an older one.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional, Set, Tuple

from ..structs import Evaluation, EVAL_TRIGGER_MAX_PLANS


class BlockedEvals:
    def __init__(self, broker) -> None:
        self.broker = broker
        self._lock = threading.Lock()
        self._enabled = False
        # eval id -> eval
        self._captured: Dict[str, Evaluation] = {}
        # evals whose constraints escaped computed classes
        self._escaped: Set[str] = set()
        # (namespace, job_id) -> eval id (dedup)
        self._job_blocked: Dict[Tuple[str, str], str] = {}
        # classes that saw capacity changes while nothing was blocked
        self._unblock_indexes: Dict[str, int] = {}
        self.stats = {"total_blocked": 0, "total_escaped": 0}

    def set_enabled(self, enabled: bool) -> None:
        with self._lock:
            self._enabled = enabled
            if not enabled:
                self._captured.clear()
                self._escaped.clear()
                self._job_blocked.clear()
                self._unblock_indexes.clear()
                self.stats = {"total_blocked": 0, "total_escaped": 0}

    # ------------------------------------------------------------------

    def block(self, ev: Evaluation) -> None:
        with self._lock:
            if not self._enabled:
                return
            job_key = (ev.namespace, ev.job_id)
            # dedup: keep the newer eval per job
            existing_id = self._job_blocked.get(job_key)
            if existing_id is not None:
                existing = self._captured.get(existing_id)
                if (
                    existing is not None
                    and existing.create_index >= ev.create_index
                    and existing_id != ev.id
                ):
                    return
                self._remove_locked(existing_id)

            # missed unblock: capacity changed for an eligible class since
            # the eval was created -> requeue immediately
            # (reference blocked_evals.go:missedUnblock)
            for klass, index in self._unblock_indexes.items():
                if index <= ev.snapshot_index:
                    continue
                eligible = ev.class_eligibility.get(klass)
                if eligible or (
                    eligible is None and not ev.escaped_computed_class
                ) or ev.escaped_computed_class:
                    self.broker.enqueue(ev)
                    return

            self._captured[ev.id] = ev
            self._job_blocked[job_key] = ev.id
            self.stats["total_blocked"] += 1
            if ev.escaped_computed_class:
                self._escaped.add(ev.id)
                self.stats["total_escaped"] += 1

    def _remove_locked(self, eval_id: str) -> None:
        ev = self._captured.pop(eval_id, None)
        if ev is None:
            return
        self._job_blocked.pop((ev.namespace, ev.job_id), None)
        self.stats["total_blocked"] -= 1
        if eval_id in self._escaped:
            self._escaped.discard(eval_id)
            self.stats["total_escaped"] -= 1

    def untrack(self, namespace: str, job_id: str) -> None:
        """Stop tracking a job's blocked eval (job was stopped/GC'd)."""
        with self._lock:
            eval_id = self._job_blocked.get((namespace, job_id))
            if eval_id:
                self._remove_locked(eval_id)

    # ------------------------------------------------------------------

    def unblock(self, computed_class: str, index: int) -> None:
        """Capacity became available for a node class
        (reference blocked_evals.go:418 Unblock)."""
        with self._lock:
            if not self._enabled:
                return
            self._unblock_indexes[computed_class] = index
            to_run = []
            for eval_id, ev in list(self._captured.items()):
                if eval_id in self._escaped:
                    to_run.append(eval_id)
                    continue
                eligible = ev.class_eligibility.get(computed_class)
                if eligible is True or eligible is None:
                    # unknown class: the eval never saw it, so it may now
                    # be feasible there
                    to_run.append(eval_id)
            for eval_id in to_run:
                ev = self._captured[eval_id]
                self._remove_locked(eval_id)
                self.broker.enqueue(ev)

    def unblock_all(self, index: int) -> None:
        with self._lock:
            if not self._enabled:
                return
            for eval_id in list(self._captured):
                ev = self._captured[eval_id]
                self._remove_locked(eval_id)
                self.broker.enqueue(ev)

    def unblock_quota(self, quota: str, index: int) -> None:
        with self._lock:
            for eval_id, ev in list(self._captured.items()):
                if ev.quota_limit_reached == quota:
                    self._remove_locked(eval_id)
                    self.broker.enqueue(ev)

    # ------------------------------------------------------------------

    def blocked_count(self) -> int:
        return self.stats["total_blocked"]
