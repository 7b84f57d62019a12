"""The device supervisor's canary: ``a + 1`` and its sum.

Counterpart of the JAX supervisor's jitted ``lambda a: a + 1`` followed
by ``.sum()`` (`nomad_tpu/device/supervisor.py:494`).  ``canary`` runs
kernel K8 (``csrc/canary.cu``) for a CUDA tensor and its plain twin
``canary_plain`` for a CPU one.  Both sum in the same fixed order (one
partial sum per thread of K8's block, then halving), so their sums are
the same bits; for ``ones(8)`` the sum is exactly 16.0.
"""
from __future__ import annotations

from typing import Tuple

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
