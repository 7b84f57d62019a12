"""Where the port runs, with no fallback.

Every entry point takes a ``device``.  ``None`` means the CUDA card and
raises when there is none; the CPU is used only when the caller asks
for it with ``"cpu"`` (the tests do, to run the plain-PyTorch twins).
A run that meant to measure the card must never carry on on the CPU.
"""
from __future__ import annotations

import shutil
import subprocess
from typing import Dict, Optional, Union

import torch

DeviceLike = Union[None, str, torch.device]


class NoDeviceError(RuntimeError):
    """A CUDA device was asked for (explicitly or by default) and this
    process has none."""


class DeviceFault(RuntimeError):
    """The device path failed (staging, a kernel's build or launch, the
    fetch of its result).  Fatal to the worker that met it: its device
    state is suspect, and carrying on with the host oracle instead would
    hide the fault."""


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda`` (current card); ``"cpu"`` -> CPU; any other
    spelling must name a CUDA device that exists."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev!s}: use cuda or cpu")
    if not torch.cuda.is_available():
        raise NoDeviceError(
            f"device {dev!s} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain twins on the CPU"
        )
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.index >= torch.cuda.device_count():
        raise NoDeviceError(
            f"device {dev!s} requested but only "
            f"{torch.cuda.device_count()} CUDA device(s) exist"
        )
    return dev


def nvidia_smi_line() -> Optional[str]:
    """``name, power.limit`` of the visible card(s) as nvidia-smi prints
    them, or None where nvidia-smi is absent."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=False,
    )
    if out.returncode != 0:
        return None
    return out.stdout.strip()


def device_report(device: DeviceLike = None) -> Dict:
    """Name, count and nvidia-smi line of the card ``device`` resolves
    to (raises without one)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("device_report describes a CUDA device")
    return {
        "name": torch.cuda.get_device_name(dev),
        "count": torch.cuda.device_count(),
        "nvidia_smi": nvidia_smi_line(),
    }
