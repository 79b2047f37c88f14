"""Fine-tuning optimizers with optax's update rules (torch).

``vln_hamt_tpu/agents/agent.py:make_optimizer`` builds
``optax.adamw`` / ``adam`` / ``rmsprop`` / ``sgd``, optionally behind
``optax.clip_by_global_norm``. PyTorch's own optimizers differ from
those: ``torch.optim.AdamW`` decays weights by 0.01 unless told
otherwise, ``torch.optim.RMSprop`` uses decay 0.99 and
``g / (sqrt(v) + eps)`` where optax uses 0.9 and ``g / sqrt(nu + eps)``,
and ``clip_grad_norm_`` scales by ``max / (norm + 1e-6)`` where optax
scales by ``max / norm``. :class:`OptaxOptimizer` writes optax's rules
out, so a port run and a JAX run take the same steps from the same
state, and optax's Adam state carries across
(``models/convert.py:adam_state_from_flax``).

A parameter without a gradient is a parameter with a zero gradient, as
under optax; its arithmetic is skipped where that is exact (no moment
state yet, and no weight decay), which is the case of the ``fix_*``
frozen parts of the model.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np
import torch

NAMES = ("adamw", "adam", "rms", "sgd")
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.adam defaults
RMS_DECAY, RMS_EPS = 0.9, 1e-8  # optax.rmsprop defaults


class OptaxOptimizer(torch.optim.Optimizer):
    """``name`` in adamw | adamW | adam | rms | sgd, learning rate ``lr``,
    ``weight_decay`` (adamw only, as in optax), and ``grad_clip``: the
    global-norm clip applied before the update, or None.

    ``state_dict()`` holds the step count and the per-parameter moments
    (``mu`` for adam, ``nu`` for adam and rms).
    """

    def __init__(self, params: Iterable[torch.nn.Parameter], name: str, lr: float,
                 weight_decay: float = 0.0, grad_clip: Optional[float] = None):
        name = "adamw" if name == "adamW" else name
        if name not in NAMES:
            raise ValueError(f"unknown optimizer {name!r}")
        super().__init__(params, {"lr": lr, "count": 0})
        self.name = name
        self.weight_decay = weight_decay if name == "adamw" else 0.0
        self.grad_clip = grad_clip

    def _moment(self, p: torch.Tensor, key: str) -> torch.Tensor:
        st = self.state[p]
        if key not in st:
            st[key] = torch.zeros_like(p, memory_format=torch.preserve_format)
        return st[key]

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("OptaxOptimizer.step takes no closure")
        for group in self.param_groups:
            group["count"] += 1
            live = [p for p in group["params"] if p.grad is not None or self.state[p]]
            if self.weight_decay:
                # adamw on a zero gradient with zero moments still decays
                idle = [p for p in group["params"] if p.grad is None and not self.state[p]]
                if idle:
                    torch._foreach_mul_(idle, 1.0 - group["lr"] * self.weight_decay)
            if not live:
                continue
            grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in live]
            if self.grad_clip is not None:
                # optax.clip_by_global_norm: g * max / norm when norm >= max
                norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
                scale = torch.where(norm < self.grad_clip, 1.0, self.grad_clip / norm)
                grads = torch._foreach_mul(grads, scale)
            self._update(live, grads, group["lr"], group["count"])

    def _update(self, params, grads, lr: float, count: int) -> None:
        if self.name == "sgd":
            torch._foreach_add_(params, grads, alpha=-lr)
            return
        nus = [self._moment(p, "nu") for p in params]
        if self.name == "rms":
            # nu = decay * nu + (1 - decay) * g^2;  p -= lr * g / sqrt(nu + eps)
            torch._foreach_mul_(nus, RMS_DECAY)
            torch._foreach_addcmul_(nus, grads, grads, value=1.0 - RMS_DECAY)
            denom = torch._foreach_add(nus, RMS_EPS)
            torch._foreach_sqrt_(denom)
            torch._foreach_addcdiv_(params, grads, denom, value=-lr)
            return
        # adam(w): bias-corrected moments, update mu_hat / (sqrt(nu_hat) + eps)
        # (+ weight_decay * p for adamw), scaled by -lr
        mus = [self._moment(p, "mu") for p in params]
        torch._foreach_mul_(mus, ADAM_B1)
        torch._foreach_add_(mus, grads, alpha=1.0 - ADAM_B1)
        torch._foreach_mul_(nus, ADAM_B2)
        torch._foreach_addcmul_(nus, grads, grads, value=1.0 - ADAM_B2)
        denom = torch._foreach_div(nus, 1.0 - ADAM_B2 ** count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, ADAM_EPS)
        upd = torch._foreach_div(mus, 1.0 - ADAM_B1 ** count)
        torch._foreach_div_(upd, denom)
        if self.weight_decay:
            torch._foreach_add_(upd, params, alpha=self.weight_decay)
        torch._foreach_add_(params, upd, alpha=-lr)

    def load_adam_state(self, named_params: Dict[str, torch.nn.Parameter],
                        state: Dict[str, object]) -> None:
        """Install an Adam state ``{"count", "mu", "nu"}`` whose moments
        are numpy arrays keyed by the names of ``named_params``, e.g.
        from ``models/convert.py:adam_state_from_flax``."""
        if self.name not in ("adam", "adamw"):
            raise ValueError(f"an Adam state does not fit optimizer {self.name!r}")
        owned = {p for g in self.param_groups for p in g["params"]}
        for name, p in named_params.items():
            if p not in owned:
                raise KeyError(f"{name} is not a parameter of this optimizer")
            st = self.state[p]
            for key in ("mu", "nu"):
                st[key] = torch.from_numpy(np.array(state[key][name])).to(p)
        for group in self.param_groups:
            group["count"] = int(state["count"])
