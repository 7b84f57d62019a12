"""Constraint/affinity/spread compilation to columnar lookup tables.

The reference evaluates every constraint per (node, constraint) pair with
string operations (scheduler/feasible.go:750 checkConstraint — regex,
version parsing, set ops).  On TPU, strings can't ride along; instead each
node attribute column is interned (state/node_table.py) and a constraint
becomes a boolean LUT over the column's vocabulary: we run the *exact*
reference operator semantics (sched/operators.py) once per distinct value
host-side, then the per-node check is `lut[codes]` — a gather that
vectorizes over all nodes and fuses into the score kernel.  This covers
every operator including the reference's "escaped" cases (regex, version,
semver; feasible.go:776) with zero per-node host work.

LUTs are cached per (column, operand, rtarget) and extended incrementally
as vocabularies grow with node churn.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..state.node_table import MISSING, NodeTable
from ..structs import (
    Affinity,
    Constraint,
    CONSTRAINT_DISTINCT_HOSTS,
    CONSTRAINT_DISTINCT_PROPERTY,
)
from ..sched.feasible import target_column_key
from ..sched.operators import check_constraint


class MaskCompiler:
    def __init__(self, table: NodeTable) -> None:
        self.table = table
        self.regex_cache: Dict = {}
        self.version_cache: Dict = {}
        # (lkey, operand, rtarget) -> bool lut over vocab (+1 missing slot)
        self._lut_cache: Dict[Tuple[str, str, str], np.ndarray] = {}

    # ------------------------------------------------------------------

    def constraint_mask(self, constraint: Constraint) -> Optional[np.ndarray]:
        """Boolean mask[capacity]; None means "always true" (handled
        elsewhere, e.g. distinct_hosts)."""
        if constraint.operand in (
            CONSTRAINT_DISTINCT_HOSTS,
            CONSTRAINT_DISTINCT_PROPERTY,
        ):
            return None
        lkey = target_column_key(constraint.ltarget)
        rkey = target_column_key(constraint.rtarget)

        if lkey is None and rkey is None:
            ok = check_constraint(
                constraint.operand,
                constraint.ltarget,
                constraint.rtarget,
                True,
                True,
                self.regex_cache,
                self.version_cache,
            )
            return np.full(self.table.capacity, ok, dtype=bool)

        if rkey is None:
            return self._column_vs_literal(
                lkey, constraint.operand, constraint.rtarget, lhs=True
            )
        if lkey is None:
            return self._column_vs_literal(
                rkey, constraint.operand, constraint.ltarget, lhs=False
            )
        return self._column_vs_column(lkey, rkey, constraint.operand)

    def affinity_match_mask(self, affinity: Affinity) -> np.ndarray:
        c = Constraint(
            ltarget=affinity.ltarget,
            rtarget=affinity.rtarget,
            operand=affinity.operand,
        )
        mask = self.constraint_mask(c)
        if mask is None:
            mask = np.ones(self.table.capacity, dtype=bool)
        return mask

    def affinity_score_vector(
        self, affinities: List[Affinity]
    ) -> Tuple[np.ndarray, float]:
        """Per-node sum of matched affinity weights and the |weight| sum
        (reference rank.go:637-658)."""
        total = np.zeros(self.table.capacity, dtype=np.float64)
        sum_weight = 0.0
        for aff in affinities:
            sum_weight += abs(float(aff.weight))
            mask = self.affinity_match_mask(aff)
            total += mask.astype(np.float64) * float(aff.weight)
        return total, sum_weight

    # ------------------------------------------------------------------

    def _column_vs_literal(
        self, key: str, operand: str, literal: str, lhs: bool
    ) -> np.ndarray:
        if key == "":
            # unresolvable interpolation: found=False on the column side
            if lhs:
                ok = check_constraint(
                    operand, None, literal, False, True,
                    self.regex_cache, self.version_cache,
                )
            else:
                ok = check_constraint(
                    operand, literal, None, True, False,
                    self.regex_cache, self.version_cache,
                )
            return np.full(self.table.capacity, ok, dtype=bool)

        col = self.table.column(key)
        vocab = col.interner.values
        cache_key = (key, operand, literal if lhs else "\x00L:" + literal)
        lut = self._lut_cache.get(cache_key)
        if lut is None or len(lut) < len(vocab) + 1:
            lut = np.empty(len(vocab) + 1, dtype=bool)
            for i, value in enumerate(vocab):
                if lhs:
                    lut[i] = check_constraint(
                        operand, value, literal, True, True,
                        self.regex_cache, self.version_cache,
                    )
                else:
                    lut[i] = check_constraint(
                        operand, literal, value, True, True,
                        self.regex_cache, self.version_cache,
                    )
            # last slot: value missing on the node
            if lhs:
                lut[-1] = check_constraint(
                    operand, None, literal, False, True,
                    self.regex_cache, self.version_cache,
                )
            else:
                lut[-1] = check_constraint(
                    operand, literal, None, True, False,
                    self.regex_cache, self.version_cache,
                )
            self._lut_cache[cache_key] = lut
        # codes: MISSING (-1) indexes the last slot
        return lut[col.codes]

    def _column_vs_column(
        self, lkey: str, rkey: str, operand: str
    ) -> np.ndarray:
        """Both targets interpolate (rare).  Evaluate per distinct
        (lcode, rcode) pair."""
        lcol = self.table.column(lkey) if lkey else None
        rcol = self.table.column(rkey) if rkey else None
        lcodes = (
            lcol.codes
            if lcol is not None
            else np.full(self.table.capacity, MISSING, dtype=np.int32)
        )
        rcodes = (
            rcol.codes
            if rcol is not None
            else np.full(self.table.capacity, MISSING, dtype=np.int32)
        )
        pairs = np.stack([lcodes, rcodes], axis=1)
        uniq, inverse = np.unique(pairs, axis=0, return_inverse=True)
        out = np.empty(len(uniq), dtype=bool)
        for i, (lc, rc) in enumerate(uniq):
            lval = (
                lcol.interner.values[lc]
                if lcol is not None and lc != MISSING
                else None
            )
            rval = (
                rcol.interner.values[rc]
                if rcol is not None and rc != MISSING
                else None
            )
            out[i] = check_constraint(
                operand,
                lval,
                rval,
                lval is not None,
                rval is not None,
                self.regex_cache,
                self.version_cache,
            )
        return out[inverse]

    # ------------------------------------------------------------------

    def spread_kernel_inputs(
        self,
        attribute: str,
        desired_counts: Dict[str, float],
        existing_use: Dict[str, int],
        cleared_use: Optional[Dict[str, int]] = None,
        proposed_use: Optional[Dict[str, int]] = None,
    ):
        """Columns for the in-kernel spread carry (ops/batch.py
        SpreadInputs): per-node value slot codes, desired count,
        existing / pre-staged proposed / pre-staged cleared use per
        slot.  The last slot is the penalty slot (missing attribute /
        value with no target and no implicit "*"), matching
        spread_boost_vector's -1.0 semantics."""
        C = self.table.capacity
        cleared_use = cleared_use or {}
        proposed_use = proposed_use or {}
        key = target_column_key(attribute) or ""
        if key == "":
            # non-interpolatable attribute: every node is a penalty
            codes = np.zeros(C, dtype=np.int32)
            z = np.zeros(1)
            return codes, z, z, z, z
        col = self.table.column(key)
        vocab = col.interner.values
        V = len(vocab)
        slot_of = np.full(V + 1, V, dtype=np.int32)
        desired = np.zeros(V + 1, dtype=np.float64)
        used0 = np.zeros(V + 1, dtype=np.float64)
        proposed0 = np.zeros(V + 1, dtype=np.float64)
        cleared0 = np.zeros(V + 1, dtype=np.float64)
        for i, value in enumerate(vocab):
            if desired_counts is None:
                # even-spread mode (no targets): every observed value
                # gets a slot; desired is unused
                d = 0.0
            else:
                d = desired_counts.get(value)
                if d is None:
                    d = desired_counts.get("*")
                if d is None:
                    continue  # stays on the penalty slot
            slot_of[i] = i
            desired[i] = d
            used0[i] = float(existing_use.get(value, 0))
            proposed0[i] = float(proposed_use.get(value, 0))
            cleared0[i] = float(cleared_use.get(value, 0))
        node_codes = np.where(col.codes >= 0, col.codes, V)
        codes = slot_of[node_codes]
        return codes, desired, used0, proposed0, cleared0

    def spread_boost_vector(
        self,
        attribute: str,
        weight_frac: Optional[float],
        desired_counts: Optional[Dict[str, float]],
        combined_use: Dict[str, int],
    ) -> np.ndarray:
        """Per-node spread score contribution for one spread attribute.

        Target mode (reference spread.go:163): boost =
        ((desired - (used+1)) / desired) * weight_frac, -1 for values with
        no desired count and no implicit target, -1 when the attribute is
        missing.  Even mode (spread.go:178): the min/max-delta formula.
        The per-*value* boost is computed host-side over the vocabulary and
        gathered per node.
        """
        key = target_column_key(attribute)
        if key is None:
            # constant attribute (not an interpolation): every node shares
            # one value
            key = ""
        if key == "":
            return np.full(self.table.capacity, -1.0, dtype=np.float64)
        col = self.table.column(key)
        vocab = col.interner.values
        boosts = np.empty(len(vocab) + 1, dtype=np.float64)

        if desired_counts is not None:
            for i, value in enumerate(vocab):
                used = combined_use.get(value, 0) + 1
                desired = desired_counts.get(value)
                if desired is None:
                    desired = desired_counts.get("*")
                if desired is None:
                    boosts[i] = -1.0
                    continue
                boosts[i] = ((desired - float(used)) / desired) * weight_frac
            boosts[-1] = -1.0  # missing property
        else:
            # even-spread mode
            if not combined_use:
                boosts[:] = 0.0
                boosts[-1] = 0.0
                return boosts[col.codes]
            counts = list(combined_use.values())
            min_count = 0
            max_count = 0
            for v in counts:
                if min_count == 0 or v < min_count:
                    min_count = v
                if max_count == 0 or v > max_count:
                    max_count = v
            for i, value in enumerate(vocab):
                current = combined_use.get(value, 0)
                if min_count == 0:
                    delta_boost = -1.0
                else:
                    delta_boost = float(min_count - current) / float(
                        min_count
                    )
                if current != min_count:
                    boosts[i] = delta_boost
                elif min_count == max_count:
                    boosts[i] = -1.0
                elif min_count == 0:
                    boosts[i] = 1.0
                else:
                    boosts[i] = float(max_count - min_count) / float(
                        min_count
                    )
            boosts[-1] = -1.0
        return boosts[col.codes]

    # ------------------------------------------------------------------

    def device_feasibility(
        self, requests: List
    ) -> Optional[np.ndarray]:
        """Mask of nodes with enough free matching device instances for
        every request (reference feasible.go:1138 DeviceChecker +
        capacity accounting)."""
        if not requests:
            return None
        table = self.table
        mask = np.ones(table.capacity, dtype=bool)
        for req in requests:
            matching_codes = set()
            for code in range(len(table.device_sigs)):
                if not table.device_sig_matches(code, req.name):
                    continue
                if not self._device_sig_meets_constraints(code, req):
                    continue
                matching_codes.add(code)
            total = np.zeros(table.capacity, dtype=np.int32)
            for row, groups in table.device_groups.items():
                for code, count in groups:
                    if code in matching_codes:
                        total[row] += count
            used = np.zeros(table.capacity, dtype=np.int32)
            for (row, key), count in table.device_used.items():
                for code in matching_codes:
                    sig = table._device_sig_meta[code]
                    if (sig[0], sig[1], sig[2]) == key:
                        used[row] += count
                        break
            mask &= (total - used) >= req.count
        return mask

    def _device_sig_meets_constraints(self, code: int, req) -> bool:
        from ..sched.feasible import _resolve_device_target
        from ..structs import NodeDeviceResource

        sig = self.table._device_sig_meta[code]
        group = NodeDeviceResource(
            vendor=sig[0], type=sig[1], name=sig[2],
            attributes=dict(sig[3]),
        )
        for constraint in req.constraints:
            lval, lok = _resolve_device_target(constraint.ltarget, group)
            rval, rok = _resolve_device_target(constraint.rtarget, group)
            if not check_constraint(
                constraint.operand, lval, rval, lok, rok,
                self.regex_cache, self.version_cache,
            ):
                return False
        return True
