"""The port's device layer: where it runs, and the supervisor that owns
the card's liveness.  Port of `nomad_tpu/device/`.

* ``core``        — ``resolve_device`` (the CUDA card unless the caller
  asks for the CPU; no fallback), ``DeviceFault``, ``NoDeviceError``
  and the card's report;
* ``supervisor``  — the DeviceSupervisor state machine
  (HEALTHY -> DEGRADED -> LOST -> RECOVERING) with canary health
  probes (kernel K8, ``csrc/canary.cu``), EWMA-budgeted stage
  watchdogs, and the hold that parks every worker while the card is
  lost;
* ``watchdog``    — sacrificial-thread bounded calls and per-stage
  deadline budgets (a wedged CUDA call is *abandoned*, never joined);
* ``faults``      — deterministic fault injection
  (``NOMAD_TPU_FAULT=wedge_launch|slow_fetch|init_block|flaky``) so
  every transition is testable on the CPU;
* ``preflight``   — ``python -m nomad_tpu_torch.device.preflight``,
  the bounded canary probe as a standalone check;
* ``config``      — ``DeviceConfig``, the supervisor's knobs.
"""
from .core import (
    DeviceFault,
    DeviceLike,
    NoDeviceError,
    device_report,
    nvidia_smi_line,
    resolve_device,
)
from .config import DeviceConfig
from .faults import FaultPlan, InjectedFault
from .supervisor import (
    CPU_ONLY,
    DEGRADED,
    HEALTHY,
    LOST,
    RECOVERING,
    STATE_CODES,
    DeviceLost,
    DeviceSupervisor,
)
from .watchdog import BudgetTracker, DeviceTimeout, bounded_call

__all__ = [
    "BudgetTracker",
    "CPU_ONLY",
    "DEGRADED",
    "DeviceConfig",
    "DeviceFault",
    "DeviceLike",
    "DeviceLost",
    "DeviceSupervisor",
    "DeviceTimeout",
    "FaultPlan",
    "HEALTHY",
    "InjectedFault",
    "LOST",
    "NoDeviceError",
    "RECOVERING",
    "STATE_CODES",
    "bounded_call",
    "device_report",
    "nvidia_smi_line",
    "resolve_device",
]
