"""The attention kernels' counter-hash keep mask, a frozen copy.

The port's kernels (``vln_hamt_torch/ops/attention.py:
dropout_keep_mask``, itself the TPU kernel's) keep an attention
probability where a 32-bit hash of (seed, batch row, head, query row x
Lk + key column) is at or above ``rate * 2**32``. The hash is
splitmix32's finaliser; products are taken mod 2**32 on int64 tensors by
16-bit halves, so that none overflows.
"""

from __future__ import annotations

import torch

_MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _mix(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def keep_mask(seed: int, b: int, h: int, lq: int, lk: int, rate: float, device) -> torch.Tensor:
    """(B, H, Lq, Lk) bool: True where the probability is kept."""
    def ar(n):
        return torch.arange(n, dtype=torch.int64, device=device)
    idx = (ar(lq)[:, None] * lk + ar(lk)[None, :]) & _MASK32
    key = ((int(seed) & _MASK32) + _mul32(ar(b), 0x9E3779B1)[:, None]
           + _mul32(ar(h), 0x85EBCA77)[None, :]) & _MASK32
    bits = _mix(key[:, :, None, None] ^ _mix(idx)[None, None])
    return bits >= min(int(rate * 4294967296.0), 4294967295)
