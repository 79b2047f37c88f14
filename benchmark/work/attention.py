"""The least time of the attention work of an update and of a greedy
rollout, launch by launch.

A frozen copy of the bound arithmetic of ``vln_hamt_torch/run/
profile_attention.py`` (``attention_bound_ms``, ``attention_bwd_bound_ms``):
each input byte read once and each output byte written once over HBM at
3.35 TB/s, the operations over the peak of the inputs' type, the larger
of the two. The backward's operations are the 8 B H Lq Lk Dh that its
outputs need (the probabilities' cotangent, dV, dQ, dK); the scores it
computes again are recomputation and are not counted. The launches are
those of :mod:`.flops`' walk over the configuration, whatever kernel
runs them.
"""

from __future__ import annotations

from typing import Dict

from . import flops

HBM_BYTES_PER_S = 3.35e12
ELT_BYTES = {"float32": 4, "bfloat16": 2}


def fwd_bound_s(b, h, lq, lk, dh, dtype: str) -> float:
    e = ELT_BYTES[dtype]
    nbytes = b * h * (lq + 2 * lk) * dh * e + b * lk * 4 + b * h * lq * dh * 4
    return max(nbytes / HBM_BYTES_PER_S, 4.0 * b * h * lq * lk * dh / flops.peak(dtype))


def bwd_bound_s(b, h, lq, lk, dh, dtype: str) -> float:
    e = ELT_BYTES[dtype]
    qkv = b * h * (lq + 2 * lk) * dh * e
    nbytes = 2 * qkv + b * h * lq * dh * 4 + 2 * b * lk * 4
    return max(nbytes / HBM_BYTES_PER_S, 8.0 * b * h * lq * lk * dh / flops.peak(dtype))


def _bounds(count: "flops.Count", dtype: str) -> Dict[str, float]:
    fwd = sum(fwd_bound_s(*c[:5], dtype) for c in count.cores)
    bwd = sum(bwd_bound_s(*c[:5], dtype) for c in count.cores if c[5])
    return {"fwd": fwd, "bwd": bwd, "launches_fwd": len(count.cores),
            "launches_bwd": sum(1 for c in count.cores if c[5])}


def update_bound_s(m: dict, env: dict, rl_lanes: int, il_lanes: int) -> Dict[str, float]:
    """One merged update as the port runs it: every step of the horizon."""
    count = flops.Count()
    flops.update(m, env, rl_lanes, il_lanes, env["max_action_len"], count)
    return _bounds(count, m["dtype"])


def eval_bound_s(m: dict, env: dict, lanes: int) -> Dict[str, float]:
    """One greedy rollout as the port runs it: every step of the horizon."""
    count = flops.Count()
    flops.rollout(m, env, lanes, env["max_action_len"], count)
    return _bounds(count, m["dtype"])
