"""The device supervisor's canary: ``a + 1`` and its sum.

Counterpart of the JAX supervisor's jitted ``lambda a: a + 1`` followed
by ``.sum()`` (`nomad_tpu/device/supervisor.py:494`).  ``canary`` runs
kernel K8 (``csrc/canary.cu``) for a CUDA tensor and its plain twin
``canary_plain`` for a CPU one.  Both sum in the same fixed order (one
partial sum per thread of K8's block, then halving), so their sums are
the same bits; for ``ones(8)`` the sum is exactly 16.0.

``CanaryProbe`` is K8 bound once for the supervisor's probe: its inputs,
outputs and sum live in mapped pinned host memory, so a probe is one
launch, with no allocation and no copy.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import numpy as np
import torch

MAX_THREADS = 1024


def canary_threads(n: int) -> int:
    """K8's block width for ``n`` values: the power of two at or above
    ``n``, at most 1024."""
    threads = 1
    while threads < min(n, MAX_THREADS):
        threads *= 2
    return threads


def _check(a) -> None:
    if a.dim() != 1 or a.shape[0] < 1:
        raise ValueError(
            f"canary takes a non-empty vector, got {tuple(a.shape)}"
        )
    if a.dtype not in (torch.float64, torch.float32):
        raise ValueError(f"canary takes float64 or float32, got {a.dtype}")


def canary_plain(a) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(a + 1, sum)`` with the sum in K8's order: element i goes to
    partial sum i mod T (each partial sum from 0, ascending i), then the
    T partial sums halve, s[t] + s[t + h].  Padding adds +0.0, which
    changes no partial sum."""
    _check(a)
    out = a + 1
    n = out.shape[0]
    threads = canary_threads(n)
    rows = -(-n // threads)
    padded = torch.zeros(rows * threads, dtype=out.dtype, device=out.device)
    padded[:n] = out
    acc = torch.zeros(threads, dtype=out.dtype, device=out.device)
    for row in padded.view(rows, threads):
        acc = acc + row
    while acc.shape[0] > 1:
        h = acc.shape[0] // 2
        acc = acc[:h] + acc[h:]
    return out, acc[0]


def canary_cuda(a) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8 on the current stream: the same function in one launch of one
    block.  Returns device tensors ``(out, sum)``."""
    from . import _cuda

    _check(a)
    if a.device.type != "cuda":
        raise ValueError(f"canary_cuda needs a CUDA tensor, got {a.device}")
    a = a.contiguous()
    out = torch.empty_like(a)
    total = torch.empty((), dtype=a.dtype, device=a.device)
    _cuda.launch_canary(a, out, total, threads=canary_threads(a.shape[0]))
    canary_cuda.launches += 1
    return out, total


canary_cuda.launches = 0


def canary(a) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(a + 1, its sum)``: K8 for a CUDA tensor, the twin for a CPU
    one."""
    if a.device.type == "cpu":
        return canary_plain(a)
    return canary_cuda(a)


class CanaryProbe:
    """K8 bound once to `values` (a non-empty float64 or float32 vector;
    default ``ones(8)``, the supervisor's probe) on a CUDA `device` and
    `stream` (default: the device's current stream when bound).  The
    inputs, the outputs and the sum share one block of mapped pinned
    host memory (`_cuda.CanaryLaunch`), so `probe` makes one launch
    whose loads and stores cross the bus, and nothing else on the card.

    `probe` first sets the sum to NaN, which K8 never stores for finite
    inputs, so a launch that did not store reads as a failed probe, not
    as the last probe's answer.  The block lives until `close`; a
    `probe` still running then (a call parked on a wedged card) frees
    it when it returns, so no call ever touches a freed block.  Each
    launch counts on `canary_cuda.launches`.  A failed bind or launch
    raises RuntimeError."""

    def __init__(self, device, values=None, dtype: torch.dtype = torch.float64,
                 stream=None) -> None:
        from . import _cuda

        a = torch.as_tensor(np.ones(8) if values is None else values,
                            dtype=dtype)
        _check(a)
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"a bound canary needs a CUDA device, got {device}")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if stream is None:
            stream = torch.cuda.current_stream(device)
        n = a.shape[0]
        self.n, self.dtype, self.stream = n, a.dtype, stream
        self._launch = _cuda.CanaryLaunch(n, canary_threads(n), a.dtype,
                                          device, stream)
        ctype = ctypes.c_double if a.dtype == torch.float64 else ctypes.c_float
        block = (ctype * (2 * n + 1)).from_address(self._launch.host)
        self._host = np.frombuffer(block, dtype=np.float64
                                   if a.dtype == torch.float64 else np.float32)
        self._host[:n] = a.numpy()
        self._host[n:] = 0
        self._lock = threading.Lock()
        self._users = 0
        self._closing = False

    def launch(self) -> None:
        """One K8 launch on the bound stream, nothing synchronised."""
        self._launch()
        canary_cuda.launches += 1

    def probe(self) -> float:
        """Set the sum to NaN, launch K8 once, record an event on the
        bound stream and wait on it, then read the sum from host
        memory."""
        with self._lock:
            if self._closing:
                raise RuntimeError("the canary probe is closed")
            self._users += 1
        try:
            self._host[2 * self.n] = np.nan
            self.launch()
            done = torch.cuda.Event()
            done.record(self.stream)
            done.synchronize()
            return float(self._host[2 * self.n])
        finally:
            with self._lock:
                self._users -= 1
                last = self._closing and self._users == 0
            if last:
                self._free()

    def out(self) -> np.ndarray:
        """A copy of the outputs of the last launch (after a `probe`, or
        once the stream has run a `launch`)."""
        return self._host[self.n:2 * self.n].copy()

    def close(self) -> None:
        """Free the block now, or when the last running `probe` returns."""
        with self._lock:
            if self._closing:
                return
            self._closing = True
            idle = self._users == 0
        if idle:
            self._free()

    def _free(self) -> None:
        self._host = None
        self._launch.free()
