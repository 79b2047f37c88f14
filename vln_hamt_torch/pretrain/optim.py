"""Pretraining optimizer zoo (torch), the port of
``vln_hamt_tpu/pretrain/optim.py``.

Parity target: ``pretrain_src/optim/``: AdamW, RAdam, Ralamb (RAdam +
LARS trust ratio), Lookahead, RangerLars = Lookahead(Ralamb), the noam
and warmup-linear LR schedules (optim/sched.py) and the two-group weight
decay (optim/misc.py:12-37: no decay for biases and LayerNorm
parameters). The update rules are optax's, as the JAX package composes
them, written out in ``agents/optim.py:OptaxOptimizer``; the schedules
reproduce optax's float32 arithmetic.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import numpy as np
from torch import nn

from ..agents.optim import OptaxOptimizer
from ..parallel.mesh import param_partition_spec

Schedule = Callable[[int], float]


def noam_schedule(base_lr: float, warmup_steps: int) -> Schedule:
    """lr * min(step^-0.5, step * warmup^-1.5) * warmup^0.5 (optim/sched.py
    noam), step counted from 1."""
    f32 = np.float32

    def sched(step: int) -> float:
        s = f32(max(step, 1))
        return float(f32(base_lr) * min(s ** f32(-0.5), s * f32(warmup_steps) ** f32(-1.5))
                     * f32(warmup_steps) ** f32(0.5))

    return sched


def _linear(init: float, end: float, steps: int, count: int) -> float:
    """optax.linear_schedule in float32."""
    f32 = np.float32
    if steps <= 0:
        return float(f32(init))
    frac = f32(1) - f32(min(max(count, 0), steps)) / f32(steps)
    return float((f32(init) - f32(end)) * frac + f32(end))


def warmup_linear_schedule(lr: float, warmup_steps: int, total_steps: int) -> Schedule:
    """Linear warm-up from 0 to ``lr`` over ``warmup_steps``, then linear
    decay to 0 at ``total_steps`` (``optax.join_schedules`` with its
    boundary at ``step == warmup_steps``, which takes the second piece)."""
    decay_steps = max(total_steps - warmup_steps, 1)

    def sched(step: int) -> float:
        if step < warmup_steps:
            return _linear(0.0, lr, warmup_steps, step)
        return _linear(lr, 0.0, decay_steps, step - warmup_steps)

    return sched


def decay_mask(model: nn.Module) -> Dict[str, bool]:
    """Per parameter name, True where weight decay applies: everything
    but biases and LayerNorm parameters (optim/misc.py:12-37). The JAX
    package keys the same rule on flax names (``bias``, ``LayerNorm``,
    ``*_ln``, ``ln``); here it keys on the module type, which selects the
    same tensors under the reference's names."""
    ln = {id(p) for m in model.modules() if isinstance(m, nn.LayerNorm)
          for p in m.parameters(recurse=False)}
    return {name: not (name.rsplit(".", 1)[-1] == "bias" or id(p) in ln)
            for name, p in model.named_parameters()}


def build_pretrain_optimizer(name: str, model: nn.Module, lr: Union[float, Schedule],
                             weight_decay: float = 0.01, grad_norm: Optional[float] = None,
                             grad_accum: int = 1, mesh=None) -> OptaxOptimizer:
    """The optimizer of ``model``'s parameters (pretrain_src/optim):
    adamw | adam | radam | ralamb | lookahead (lookahead around adam) |
    rangerlars (lookahead around ralamb), as the JAX package composes
    them: global-norm clipping at ``grad_norm`` first; ``adamw`` is
    ``optax.adamw`` without the no-decay mask (every parameter decays),
    radam and ralamb take the mask of :func:`decay_mask`; ``grad_accum``
    accumulates as ``optax.MultiSteps`` inside the lookahead (sync every
    6 micro-batches, slow step 0.5), whose sync counter ticks per
    micro-batch. ``mesh``: the rank's groups (``agents/optim.py``), the
    split parameters named by ``parallel/mesh.py:param_partition_spec``."""
    if name not in ("adamw", "adam", "radam", "ralamb", "lookahead", "rangerlars"):
        raise ValueError(f"unknown pretrain optimizer {name!r}")
    mask = decay_mask(model)
    params = dict(model.named_parameters())
    return OptaxOptimizer(params.values(), name, lr, weight_decay=weight_decay,
                          grad_clip=grad_norm, decay=[params[k] for k, d in mask.items() if d],
                          grad_accum=grad_accum, mesh=mesh,
                          sharded=[p for k, p in params.items()
                                   if mesh is not None and mesh.model_shards > 1
                                   and param_partition_spec(k) is not None])
