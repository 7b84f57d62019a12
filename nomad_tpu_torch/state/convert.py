"""Carry state across from the JAX package: what weight conversion is to
a model port.

`load_cluster` takes the JAX package's API dict encodings of nodes,
jobs and allocations (`nomad_tpu/api/codec.py` job_to_dict,
node_to_dict, alloc_to_dict — plain dicts, so nothing of that package
is imported), and optionally the field dict of its scheduler
configuration (`dataclasses.asdict` of a `SchedulerConfiguration`,
preemption config included), and rebuilds them in this package's
`StateStore`.  Nodes are inserted in the given order, so the port's
node arena assigns the same rows as the store they came from.

`score_inputs_from_numpy`, `batch_inputs_from_numpy` and the chained
planner's `chain_inputs_from_numpy` (with `spread_inputs_from_numpy`,
`step_deltas_from_numpy`, `pre_deltas_from_numpy`,
`port_inputs_from_numpy`, `device_inputs_from_numpy` and
`chain_case_to_torch`) and the shared-snapshot batch's
`batch_shared_inputs_from_numpy` turn numpy kernel inputs (the shape the JAX
programs take) into the port's tensor NamedTuples, for the
kernel-level tests.

The decode half below is this package's own copy of codec.py's generic
inverse (`dataclass_from_dict`, `alloc_from_dict`), extended to rebuild
``Tuple[X, ...]`` fields (spread targets) as tuples of dataclasses.
"""
from __future__ import annotations

import dataclasses
import typing
from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch

from ..ops.batch import (
    BatchInputs,
    ChainInputs,
    DeviceInputs,
    PortInputs,
    PreDeltas,
    SpreadInputs,
    StepDeltas,
)
from ..ops.score import PolicyTerms, ScoreInputs
from ..ops.solve import StormInputs
from ..structs import Allocation, Job, Node, SchedulerConfiguration
from .store import StateStore


def dataclass_from_dict(cls, raw):
    """Rebuild a dataclass from its snake_case JSON form via type hints
    (List/Tuple/Dict/Optional/nested dataclasses).  Unknown keys are
    ignored; `job`/`metrics` never ride the wire and decode to their
    defaults."""
    if raw is None or not dataclasses.is_dataclass(cls):
        return raw

    def thaw(hint, value):
        if value is None:
            return None
        origin = typing.get_origin(hint)
        if origin is typing.Union:
            args = [
                a
                for a in typing.get_args(hint)
                if a is not type(None)
            ]
            return thaw(args[0], value) if args else value
        if origin in (list, List):
            (item,) = typing.get_args(hint) or (Any,)
            return [thaw(item, v) for v in value]
        if origin is tuple:
            args = typing.get_args(hint)
            if len(args) == 2 and args[1] is Ellipsis:
                return tuple(thaw(args[0], v) for v in value)
            if args:
                return tuple(thaw(a, v) for a, v in zip(args, value))
            return tuple(value)
        if origin in (dict, Dict):
            args = typing.get_args(hint) or (Any, Any)
            return {k: thaw(args[1], v) for k, v in value.items()}
        if dataclasses.is_dataclass(hint) and isinstance(value, dict):
            return dataclass_from_dict(hint, value)
        if hint is float:
            return float(value)
        if hint is int:
            return int(value)
        if hint is bool:
            return bool(value)
        if hint is bytes and isinstance(value, str):
            import base64

            return base64.b64decode(value)
        return value

    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name in raw:
            kwargs[f.name] = thaw(hints[f.name], raw[f.name])
    return cls(**kwargs)


def alloc_from_dict(raw: Dict) -> Allocation:
    """Wire form -> Allocation (full decode incl. task_states and
    allocated_resources)."""
    return dataclass_from_dict(Allocation, raw)


def node_from_dict(raw: Dict) -> Node:
    return dataclass_from_dict(Node, raw)


def job_from_dict(raw: Dict) -> Job:
    return dataclass_from_dict(Job, raw)


def scheduler_config_from_dict(raw: Dict) -> SchedulerConfiguration:
    """The whole scheduler configuration (algorithm, preemption per
    scheduler type, the device-stack switch) from its field dict."""
    return dataclass_from_dict(SchedulerConfiguration, raw)


# fields the store stamps on insert; restored from the wire form so the
# carried world keeps the source's versions and indices
_JOB_STAMPS = ("version", "create_index", "modify_index",
               "job_modify_index", "status")


def load_cluster(
    nodes: Iterable[Dict],
    jobs: Iterable[Dict],
    allocs: Iterable[Dict],
    store: Optional[StateStore] = None,
    scheduler_config: Optional[Dict] = None,
) -> StateStore:
    """Build (or extend) a port StateStore from API dict encodings.

    The scheduler configuration, when given, is set first.  Nodes go in
    next, in the given order (so arena rows match the source store's
    when it, too, inserted them in that order), then jobs, then
    allocations in one batch.  A job may appear once per version,
    oldest first; each keeps the version and indices it had at the
    source.  Each allocation is relinked to its job version by
    (namespace, id, ``job_version``); the wire form does not carry the
    job itself."""
    store = store if store is not None else StateStore()
    if scheduler_config is not None:
        store.set_scheduler_config(
            scheduler_config_from_dict(scheduler_config)
        )
    for raw in nodes:
        store.upsert_node(node_from_dict(raw))
    for raw in jobs:
        job = job_from_dict(raw)
        store.upsert_job(job)
        for name in _JOB_STAMPS:
            if name in raw:
                setattr(job, name, raw[name])
    decoded: List[Allocation] = []
    for raw in allocs:
        alloc = alloc_from_dict(raw)
        version = raw.get("job_version")
        job = None
        if version is not None:
            job = store.job_by_version(alloc.namespace, alloc.job_id, version)
        alloc.job = job or store.job_by_id(alloc.namespace, alloc.job_id)
        decoded.append(alloc)
    if decoded:
        store.upsert_allocs(decoded)
    return store


def _tensor(value, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(value)).to(
        device=device, dtype=dtype
    )


def score_inputs_from_numpy(arrays: Dict[str, Any], device,
                            dtype=torch.float64) -> ScoreInputs:
    """ScoreInputs from numpy columns keyed by field name.  Float
    columns become `dtype`, masks bool, counts and perm int32; scalars
    stay Python numbers.  An optional "policy" entry (a dict of
    tput_term, has_tput and mig_term, each may be None) becomes
    `PolicyTerms`."""
    f = ("cpu_total", "mem_total", "disk_total", "cpu_used", "mem_used",
         "disk_used", "affinity_score", "spread_boost")
    cols = {k: _tensor(arrays[k], dtype, device) for k in f}
    cols["feasible"] = _tensor(arrays["feasible"], torch.bool, device)
    cols["penalty"] = _tensor(arrays["penalty"], torch.bool, device)
    cols["collisions"] = _tensor(arrays["collisions"], torch.int32, device)
    cols["perm"] = _tensor(arrays["perm"], torch.int32, device)
    policy = arrays.get("policy")
    if policy is not None:
        has = policy.get("has_tput")
        policy = PolicyTerms(
            tput_term=None if policy.get("tput_term") is None
            else _tensor(policy["tput_term"], dtype, device),
            has_tput=None if has is None else float(has),
            mig_term=None if policy.get("mig_term") is None
            else _tensor(policy["mig_term"], dtype, device),
        )
    return ScoreInputs(
        **cols,
        ask_cpu=float(arrays["ask_cpu"]),
        ask_mem=float(arrays["ask_mem"]),
        ask_disk=float(arrays["ask_disk"]),
        desired_count=int(arrays["desired_count"]),
        limit=int(arrays["limit"]),
        n_candidates=int(arrays["n_candidates"]),
        policy=policy,
    )


def batch_inputs_from_numpy(arrays: Dict[str, Any], device,
                            dtype=torch.float64) -> BatchInputs:
    """BatchInputs from numpy columns keyed by field name (same type
    rules as score_inputs_from_numpy)."""
    f = ("base_cpu_used", "base_mem_used", "base_disk_used",
         "affinity_score")
    cols = {k: _tensor(arrays[k], dtype, device) for k in f}
    cols["feasible"] = _tensor(arrays["feasible"], torch.bool, device)
    cols["penalty"] = _tensor(arrays["penalty"], torch.bool, device)
    cols["base_collisions"] = _tensor(
        arrays["base_collisions"], torch.int32, device
    )
    cols["perm"] = _tensor(arrays["perm"], torch.int32, device)
    return BatchInputs(
        **cols,
        ask_cpu=float(arrays["ask_cpu"]),
        ask_mem=float(arrays["ask_mem"]),
        ask_disk=float(arrays["ask_disk"]),
        desired_count=int(arrays["desired_count"]),
        limit=int(arrays["limit"]),
        distinct_hosts=bool(arrays["distinct_hosts"]),
    )


def _fields_from_numpy(cls, arrays: Dict[str, Any], floats, device,
                       dtype) -> Any:
    """A NamedTuple of tensors: fields named in `floats` become `dtype`,
    bool arrays stay bool, integer arrays become int32; absent or None
    fields stay None."""
    out = {}
    for name in cls._fields:
        value = arrays.get(name)
        if value is None:
            out[name] = None
            continue
        value = np.asarray(value)
        if name in floats:
            want = dtype
        elif value.dtype == np.bool_:
            want = torch.bool
        else:
            want = torch.int32
        out[name] = _tensor(value, want, device)
    return cls(**out)


def chain_inputs_from_numpy(arrays: Dict[str, Any], device,
                            dtype=torch.float64) -> ChainInputs:
    return _fields_from_numpy(
        ChainInputs, arrays, ("ask_cpu", "ask_mem", "ask_disk"), device,
        dtype,
    )


def spread_inputs_from_numpy(arrays: Dict[str, Any], device,
                             dtype=torch.float64) -> SpreadInputs:
    return _fields_from_numpy(
        SpreadInputs, arrays,
        ("desired", "used0", "proposed0", "cleared0", "weight"), device,
        dtype,
    )


def step_deltas_from_numpy(arrays: Dict[str, Any], device,
                           dtype=torch.float64) -> StepDeltas:
    return _fields_from_numpy(
        StepDeltas, arrays, ("evict_cpu", "evict_mem", "evict_disk"),
        device, dtype,
    )


def pre_deltas_from_numpy(arrays: Dict[str, Any], device,
                          dtype=torch.float64) -> PreDeltas:
    return _fields_from_numpy(
        PreDeltas, arrays, ("cpu", "mem", "disk"), device, dtype
    )


def port_inputs_from_numpy(arrays: Dict[str, Any], device) -> PortInputs:
    return _fields_from_numpy(PortInputs, arrays, (), device, None)


def device_inputs_from_numpy(arrays: Dict[str, Any],
                             device) -> DeviceInputs:
    return _fields_from_numpy(DeviceInputs, arrays, (), device, None)


def chain_case_to_torch(cols: Dict[str, Any], kw: Dict[str, Any], device,
                        dtype=torch.float64):
    """(positional args, keyword args) of `chained_plan_picks_cols` for
    a case of `ops/cases.py chain_case`, as tensors on `device`."""
    args = tuple(
        _tensor(cols[k], dtype, device)
        for k in ("cpu_total", "mem_total", "disk_total", "used0_cpu",
                  "used0_mem", "used0_disk")
    ) + (
        chain_inputs_from_numpy(kw["batch"], device, dtype),
        _tensor(kw["n_candidates"], torch.int32, device),
        int(kw["n_picks"]),
    )
    out = {"wanted": _tensor(kw["wanted"], torch.int32, device)}
    convert = {
        "spread": spread_inputs_from_numpy,
        "deltas": step_deltas_from_numpy,
        "pre": pre_deltas_from_numpy,
    }
    for name, fn in convert.items():
        if kw.get(name) is not None:
            out[name] = fn(kw[name], device, dtype)
    for name in ("coll0", "affinity", "port_ask", "port_used0", "dev_ask",
                 "dev_free0", "dev_aff", "dev_aff_on", "occ0", "dh_tg"):
        value = kw.get(name)
        if value is None:
            continue
        value = np.asarray(value)
        if value.dtype == np.bool_:
            want = torch.bool
        elif value.dtype.kind == "f":
            want = dtype
        else:
            want = torch.int32
        out[name] = _tensor(value, want, device)
    return args, out


def batched_inputs_from_numpy(arrays: Dict[str, Any], device,
                              dtype=torch.float64) -> BatchInputs:
    """BatchInputs with a leading E (the inputs of `chained_plan_picks`
    and `batch_plan_picks`): [E, C] columns and [E] scalars as tensors,
    floats in `dtype`, masks bool, counts, limits and perms int32."""
    return _fields_from_numpy(
        BatchInputs, arrays,
        ("base_cpu_used", "base_mem_used", "base_disk_used",
         "affinity_score", "ask_cpu", "ask_mem", "ask_disk"), device, dtype,
    )


def batched_case_to_torch(cols: Dict[str, Any], kw: Dict[str, Any], device,
                          dtype=torch.float64):
    """(positional args, keyword args) of `chained_plan_picks` for a case
    of `ops/cases.py batched_case`, as tensors on `device` (n_candidates
    an int32 [E] tensor)."""
    args = tuple(
        _tensor(cols[k], dtype, device)
        for k in ("cpu_total", "mem_total", "disk_total")
    ) + (
        batched_inputs_from_numpy(kw["batch"], device, dtype),
        _tensor(kw["n_candidates"], torch.int32, device),
        int(kw["n_picks"]),
    )
    out = {"wanted": _tensor(kw["wanted"], torch.int32, device)}
    convert = {
        "spread": spread_inputs_from_numpy,
        "deltas": step_deltas_from_numpy,
        "pre": pre_deltas_from_numpy,
    }
    for name, fn in convert.items():
        if kw.get(name) is not None:
            out[name] = fn(kw[name], device, dtype)
    return args, out


def batch_shared_inputs_from_numpy(arrays: Dict[str, Any], device,
                                   dtype=torch.float64) -> Dict[str, Any]:
    """The keyword arguments of `ops.batch.batch_plan_picks_shared` from
    the numpy ones of the JAX program (an `ops/cases.py
    batch_shared_case`, or what the bridge stages): node columns and
    asks become `dtype`, `feasible` bool, perms, counts and limits
    int32, all on `device`; `n_candidates` and `n_picks` stay ints."""
    out = {
        k: _tensor(arrays[k], dtype, device)
        for k in ("cpu_total", "mem_total", "disk_total", "base_cpu_used",
                  "base_mem_used", "base_disk_used", "ask_cpu", "ask_mem",
                  "ask_disk")
    }
    out["feasible"] = _tensor(arrays["feasible"], torch.bool, device)
    for k in ("perms", "desired_count", "limit"):
        out[k] = _tensor(arrays[k], torch.int32, device)
    out["n_candidates"] = int(arrays["n_candidates"])
    out["n_picks"] = int(arrays["n_picks"])
    return out


def storm_inputs(np_inputs, device, dtype=torch.float64) -> StormInputs:
    """The port's `StormInputs` from numpy ones: a dict keyed by field
    name or the JAX package's `StormInputs` (its host staging; any
    NamedTuple with those fields).  Float fields become `dtype`, masks
    bool, indices and counts int32; absent policy fields stay None."""
    if hasattr(np_inputs, "_asdict"):
        np_inputs = np_inputs._asdict()
    return _fields_from_numpy(
        StormInputs, np_inputs,
        ("affinity", "ask", "pre_cpu", "pre_mem", "pre_disk",
         "policy_tput_term", "policy_has_tput", "policy_mig_term"),
        device, dtype,
    )


def storm_columns(cols: Dict[str, Any], device, dtype=torch.float64):
    """The six node columns of a storm solve (cpu/mem/disk totals, then
    used) as `dtype` tensors on `device`."""
    return tuple(
        _tensor(cols[k], dtype, device)
        for k in ("cpu_total", "mem_total", "disk_total", "cpu_used",
                  "mem_used", "disk_used")
    )


def _fields_of(x) -> Dict[str, Any]:
    """A NamedTuple's (or dict's) fields by name: the JAX package's
    StepDeltas / PreDeltas / SpreadInputs are read this way, so nothing
    of it is imported."""
    if isinstance(x, dict):
        return x
    return {f: getattr(x, f) for f in x._fields}


# the float members of the sharded runner's per-eval tuple
_SHARDED_FLOATS = (2, 3, 4, 11)


def sharded_chain_args(cols, per_eval, spread=None, device="cpu",
                       dtype=torch.float64) -> tuple:
    """The positional arguments of the port's `sharded_chained_plan`
    runner from the JAX runner's host inputs (the tuples of
    `parallel/multichip.py _chain_inputs`, the tests' arrays): `cols` is
    (cpu_total, mem_total, disk_total, used0_cpu, used0_mem, used0_disk)
    and `per_eval` (feasible [E, C], perm, ask_cpu, ask_mem, ask_disk,
    desired_count, limits, wanted, n_candidates, distinct_hosts, coll0,
    affinity, StepDeltas, PreDeltas), the two NamedTuples (or dicts) read
    by field name; `spread` a SpreadInputs or its dict.  Tensors on
    `device`, floats in `dtype`, masks bool, the rest int32."""
    out = [_tensor(np.asarray(c), dtype, device) for c in cols]
    for i, x in enumerate(per_eval[:12]):
        x = np.asarray(x)
        if i in _SHARDED_FLOATS:
            want = dtype
        elif x.dtype == np.bool_:
            want = torch.bool
        else:
            want = torch.int32
        out.append(_tensor(x, want, device))
    out.append(step_deltas_from_numpy(_fields_of(per_eval[12]), device, dtype))
    out.append(pre_deltas_from_numpy(_fields_of(per_eval[13]), device, dtype))
    if spread is not None:
        fields = dict(_fields_of(spread))
        fields.pop("group", None)
        out.append(spread_inputs_from_numpy(fields, device, dtype))
    return tuple(out)


def sharded_case_args(case: Dict[str, Any], device="cpu",
                      dtype=torch.float64) -> tuple:
    """`sharded_chain_args` of an `ops/cases.py sharded_chain_case`."""
    from ..ops.cases import SHARDED_PER_EVAL

    per_eval = tuple(case["per_eval"][k] for k in SHARDED_PER_EVAL) + (
        case["deltas"], case["pre"])
    return sharded_chain_args(case["cols"], per_eval, case["spread"],
                              device, dtype)
