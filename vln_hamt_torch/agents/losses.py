"""Training losses (torch), the port of ``vln_hamt_tpu/agents/losses.py``.

Parity targets in ``finetune_src/r2r/agent_cmt.py``:
- IL: summed cross entropy with ignore index (-100), scaled by
  ``train_ml / batch_size`` by the caller (agent_cmt.py:81,339,520-521;
  the reference's deprecated ``size_average=False`` means SUM reduction).
- A2C: reversed-time discounted returns with value bootstrap for
  unfinished episodes, advantage-weighted policy gradient, 0.5 L2 critic
  loss, entropy bonus (agent_cmt.py:476-518).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.distributed as dist

from ..parallel.mesh import global_sum

IGNORE_ID = -100


def masked_log_softmax(logits: torch.Tensor) -> torch.Tensor:
    """log_softmax tolerant of -inf masked entries (their log-prob is
    -inf and they add nothing to the denominator)."""
    mx = torch.where(torch.isfinite(logits), logits, -math.inf).amax(dim=-1, keepdim=True)
    shifted = logits - mx.detach()
    lse = torch.log(torch.where(torch.isfinite(shifted), torch.exp(shifted), 0.0)
                    .sum(dim=-1, keepdim=True))
    return shifted - lse


def il_loss(logits: torch.Tensor, targets: torch.Tensor,
            ignore_id: int = IGNORE_ID) -> torch.Tensor:
    """Summed masked CE. logits (..., N); targets (...) integer."""
    logp = masked_log_softmax(logits)
    valid = targets != ignore_id
    tgt = torch.where(valid, targets, 0).long()
    nll = -torch.gather(logp, -1, tgt[..., None]).squeeze(-1)
    return torch.where(valid, nll, 0.0).sum()


def entropy_from_logits(logits: torch.Tensor) -> torch.Tensor:
    """Categorical entropy over the valid (finite-logit) support.

    NaN-safe under autograd: multiplying by a raw ``logp = -inf`` would
    put ``0 * -inf`` into the backward product at masked entries and
    poison the whole gradient. Clamping the multiplicand keeps both the
    value (p = 0 there) and the gradient exact.
    """
    logp = masked_log_softmax(logits)
    p = torch.exp(logp)
    safe_logp = torch.where(torch.isfinite(logp), logp, 0.0)
    return -(p * safe_logp).sum(dim=-1)


def discounted_returns(rewards: torch.Tensor, masks: torch.Tensor,
                       last_value: torch.Tensor, gamma: float) -> torch.Tensor:
    """(T, B) rewards/masks + (B,) bootstrap -> (T, B) returns.

    Reference recurrence (agent_cmt.py:481-489): the bootstrap seeds the
    accumulator; reward rows of finished episodes are zero past their
    stop step, so the tail only decays the bootstrap, and the accumulator
    is never re-zeroed mid-episode (as in the reference). ``masks`` is
    unused, as in the JAX package.
    """
    acc = last_value
    out = []
    for t in range(rewards.shape[0] - 1, -1, -1):
        acc = acc * gamma + rewards[t]
        out.append(acc)
    return torch.stack(out[::-1])


def a2c_loss(
    logits: torch.Tensor,  # (T, B, N)
    actions: torch.Tensor,  # (T, B)
    values: torch.Tensor,  # (T, B) critic outputs (with grad)
    rewards: torch.Tensor,  # (T, B) shaped rewards
    masks: torch.Tensor,  # (T, B) 1.0 while alive at step t
    last_value: torch.Tensor,  # (B,) detached bootstrap, zero where ended
    gamma: float,
    entropy_weight: float,
    normalize: str = "total",
    use_entropy: bool = True,
    group=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """A2C loss and its parts; ``normalize`` divides by the number of
    live steps (``total``), the batch (``batch``) or nothing (``none``),
    counted over the ranks of the data ``group`` when there is one (each
    rank's loss is then its part of the global batch's, and the parts'
    gradients sum to the global gradient)."""
    returns = discounted_returns(rewards, masks, last_value, gamma).detach()
    logp = masked_log_softmax(logits)
    act_logp = torch.gather(logp, -1, actions.long()[..., None]).squeeze(-1)

    adv = (returns - values).detach()
    policy_loss = (-act_logp * adv * masks).sum()
    critic_loss = 0.5 * (((returns - values) ** 2) * masks).sum()
    loss = policy_loss + critic_loss
    ent = entropy_from_logits(logits)
    entropy_loss = -entropy_weight * (ent * masks).sum()
    if use_entropy:
        loss = loss + entropy_loss

    total = masks.sum()
    if normalize == "total":
        loss = loss / global_sum(total, group).clamp(min=1.0)
    elif normalize == "batch":
        loss = loss / (logits.shape[1] * (1 if group is None else dist.get_world_size(group)))
    elif normalize != "none":
        raise ValueError(f"bad normalize {normalize!r}")

    aux = {
        "policy_loss": policy_loss,
        "critic_loss": critic_loss,
        "entropy": (ent * masks).sum(),
        "total_actions": total,
    }
    return loss, aux
