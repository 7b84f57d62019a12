"""The device supervisor's knobs.  The port's own copy of
`nomad_tpu/config.py` ``DeviceConfig`` (the port imports nothing of the
JAX package; its ``config.py`` is not ported yet)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class DeviceConfig:
    """Device supervisor knobs (``nomad_tpu_torch/device``).  ``None``
    defers to the NOMAD_TPU_* env knob (and its default), so a config
    only pins what it names:

        device {
          probe_interval  = "30s"
          probe_timeout   = "10s"
          watchdog_factor = 20
          watchdog_min    = "5s"
          watchdog_max    = "2m"
        }
    """

    probe_interval_s: Optional[float] = None
    probe_timeout_s: Optional[float] = None
    watchdog_factor: Optional[float] = None
    watchdog_min_s: Optional[float] = None
    watchdog_max_s: Optional[float] = None
    lost_probes: Optional[int] = None
    recover_canaries: Optional[int] = None
    init_grace_s: Optional[float] = None
