"""Schedulers.

The oracle iterator chain (`stack.py` and the modules it composes) is
a host-side re-expression of the reference's pull-based chain;
`cuda_stack.py` is the device backend built on the CUDA kernels of
`ops/`.  `generic_sched` sits above either stack.
"""
from .scheduler import (  # noqa: F401
    BUILTIN_SCHEDULERS,
    new_scheduler,
    SchedulerError,
    SetStatusError,
)
