"""Constraint/affinity operator semantics.

Value-level implementation of the reference's `scheduler/feasible.go:750
checkConstraint` and helpers (checkLexicalOrder:799, checkVersionMatch:826,
checkRegexpMatch:893, checkSetContainsAll:925, checkSetContainsAny:958).
Shared by the host oracle chain and by the LUT compiler in
`nomad_tpu/ops/constraints.py`, which evaluates these exact semantics over
a column's vocabulary to produce device-side boolean lookup tables.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

from ..structs import (
    CONSTRAINT_ATTRIBUTE_IS_NOT_SET,
    CONSTRAINT_ATTRIBUTE_IS_SET,
    CONSTRAINT_DISTINCT_HOSTS,
    CONSTRAINT_DISTINCT_PROPERTY,
    CONSTRAINT_REGEX,
    CONSTRAINT_SEMVER,
    CONSTRAINT_SET_CONTAINS,
    CONSTRAINT_SET_CONTAINS_ALL,
    CONSTRAINT_SET_CONTAINS_ANY,
    CONSTRAINT_VERSION,
)


# ---------------------------------------------------------------------------
# Version parsing (semantics of hashicorp/go-version and blang/semver as the
# reference uses them)
# ---------------------------------------------------------------------------

_VERSION_RE = re.compile(
    r"^v?(\d+(?:\.\d+)*)(?:-([0-9A-Za-z\-~]+(?:\.[0-9A-Za-z\-~]+)*))?"
    r"(?:\+([0-9A-Za-z\-~]+(?:\.[0-9A-Za-z\-~]+)*))?$"
)


class Version:
    __slots__ = ("segments", "prerelease")

    def __init__(self, segments: Tuple[int, ...], prerelease: str) -> None:
        self.segments = segments
        self.prerelease = prerelease

    @classmethod
    def parse(cls, raw: str) -> Optional["Version"]:
        m = _VERSION_RE.match(raw.strip())
        if not m:
            return None
        segments = tuple(int(p) for p in m.group(1).split("."))
        # normalize to 3 segments like go-version
        while len(segments) < 3:
            segments = segments + (0,)
        return cls(segments, m.group(2) or "")

    def _pre_key(self):
        # a version with a prerelease sorts before the same version without
        if not self.prerelease:
            return (1,)
        parts: List = [0]
        for piece in self.prerelease.split("."):
            if piece.isdigit():
                parts.append((0, int(piece), ""))
            else:
                parts.append((1, 0, piece))
        return tuple(parts)

    def compare(self, other: "Version") -> int:
        a, b = self.segments, other.segments
        length = max(len(a), len(b))
        a = a + (0,) * (length - len(a))
        b = b + (0,) * (length - len(b))
        if a != b:
            return -1 if a < b else 1
        ka, kb = self._pre_key(), other._pre_key()
        if ka == kb:
            return 0
        return -1 if ka < kb else 1


_CONSTRAINT_OP_RE = re.compile(r"^\s*(>=|<=|!=|=|>|<|~>)?\s*(.*)$")


def check_version_constraint(
    version_str: str, constraint_str: str, strict_semver: bool = False
) -> bool:
    """Evaluate a comma-separated version constraint expression, e.g.
    ">= 1.2, < 2.0" (reference feasible.go:826 checkVersionMatch)."""
    vers = Version.parse(version_str)
    if vers is None:
        return False
    for part in constraint_str.split(","):
        m = _CONSTRAINT_OP_RE.match(part.strip())
        if not m:
            return False
        op = m.group(1) or "="
        target = Version.parse(m.group(2))
        if target is None:
            return False
        if strict_semver and op != "~>":
            # blang-style semver: prereleases only match explicitly equal asks
            pass
        cmp = vers.compare(target)
        if op == "=" and cmp != 0:
            return False
        if op == "!=" and cmp == 0:
            return False
        if op == ">" and cmp <= 0:
            return False
        if op == ">=" and cmp < 0:
            return False
        if op == "<" and cmp >= 0:
            return False
        if op == "<=" and cmp > 0:
            return False
        if op == "~>":
            # pessimistic operator: >= target and < next significant release
            if cmp < 0:
                return False
            segs = target.segments
            raw = m.group(2).strip().lstrip("v").split("-")[0]
            n_specified = len(raw.split("."))
            if n_specified >= 2:
                upper_segs = list(segs[: n_specified - 1])
                upper_segs[-1] += 1
                upper = Version(tuple(upper_segs + [0] * (3 - len(upper_segs))), "")
                if vers.compare(upper) >= 0:
                    return False
    return True


# ---------------------------------------------------------------------------
# Operator dispatch
# ---------------------------------------------------------------------------


def check_lexical_order(op: str, lval: str, rval: str) -> bool:
    if op == "<":
        return lval < rval
    if op == "<=":
        return lval <= rval
    if op == ">":
        return lval > rval
    if op == ">=":
        return lval >= rval
    return False


def check_set_contains_all(lval: str, rval: str) -> bool:
    have = {p.strip() for p in lval.split(",")}
    return all(p.strip() in have for p in rval.split(","))


def check_set_contains_any(lval: str, rval: str) -> bool:
    have = {p.strip() for p in lval.split(",")}
    return any(p.strip() in have for p in rval.split(","))


def check_regexp_match(
    lval: str, rval: str, cache: Optional[Dict[str, "re.Pattern"]] = None
) -> bool:
    pattern = cache.get(rval) if cache is not None else None
    if pattern is None:
        try:
            pattern = re.compile(rval)
        except re.error:
            return False
        if cache is not None:
            cache[rval] = pattern
    return pattern.search(lval) is not None


def check_constraint(
    operand: str,
    lval: Optional[str],
    rval: Optional[str],
    lfound: bool,
    rfound: bool,
    regex_cache: Optional[Dict] = None,
    version_cache: Optional[Dict] = None,
) -> bool:
    """Exact semantics of the reference's checkConstraint
    (feasible.go:750)."""
    if operand in (CONSTRAINT_DISTINCT_HOSTS, CONSTRAINT_DISTINCT_PROPERTY):
        # handled by dedicated iterators, always pass here
        return True

    if operand in ("=", "==", "is"):
        return lfound and rfound and lval == rval
    if operand in ("!=", "not"):
        # NB: the reference compares values without requiring found-ness
        # here (a missing attr is != any value)
        return lval != rval or lfound != rfound
    if operand in ("<", "<=", ">", ">="):
        return (
            lfound
            and rfound
            and isinstance(lval, str)
            and isinstance(rval, str)
            and check_lexical_order(operand, lval, rval)
        )
    if operand == CONSTRAINT_ATTRIBUTE_IS_SET:
        return lfound
    if operand == CONSTRAINT_ATTRIBUTE_IS_NOT_SET:
        return not lfound
    if operand == CONSTRAINT_VERSION:
        return (
            lfound
            and rfound
            and _cached_version_check(lval, rval, False, version_cache)
        )
    if operand == CONSTRAINT_SEMVER:
        return (
            lfound
            and rfound
            and _cached_version_check(lval, rval, True, version_cache)
        )
    if operand == CONSTRAINT_REGEX:
        return lfound and rfound and check_regexp_match(lval, rval, regex_cache)
    if operand in (CONSTRAINT_SET_CONTAINS, CONSTRAINT_SET_CONTAINS_ALL):
        return lfound and rfound and check_set_contains_all(lval, rval)
    if operand == CONSTRAINT_SET_CONTAINS_ANY:
        return lfound and rfound and check_set_contains_any(lval, rval)
    return False


def _cached_version_check(
    lval: str, rval: str, strict: bool, cache: Optional[Dict]
) -> bool:
    if cache is None:
        return check_version_constraint(lval, rval, strict)
    key = (lval, rval, strict)
    hit = cache.get(key)
    if hit is None:
        hit = check_version_constraint(lval, rval, strict)
        cache[key] = hit
    return hit


def check_affinity(
    operand: str,
    lval,
    rval,
    lfound: bool,
    rfound: bool,
    regex_cache=None,
    version_cache=None,
) -> bool:
    """(reference feasible.go:789 checkAffinity)"""
    return check_constraint(
        operand, lval, rval, lfound, rfound, regex_cache, version_cache
    )
