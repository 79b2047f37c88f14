"""Optimizers with optax's update rules (torch): fine-tuning's and the
pretraining zoo's.

``vln_hamt_tpu/agents/agent.py:make_optimizer`` builds
``optax.adamw`` / ``adam`` / ``rmsprop`` / ``sgd``, optionally behind
``optax.clip_by_global_norm``; ``vln_hamt_tpu/pretrain/optim.py:
build_pretrain_optimizer`` adds ``radam`` and ``ralamb`` (RAdam, masked
weight decay, then the LARS trust ratio), ``optax.lookahead`` around
adam (``lookahead``) or ralamb (``rangerlars``), learning-rate schedules
and ``optax.MultiSteps`` gradient accumulation. PyTorch's own optimizers
differ from those: ``torch.optim.AdamW`` decays weights by 0.01 unless
told otherwise, ``torch.optim.RMSprop`` uses decay 0.99 and
``g / (sqrt(v) + eps)`` where optax uses 0.9 and ``g / sqrt(nu + eps)``,
``torch.optim.RAdam`` rectifies with another threshold, and
``clip_grad_norm_`` scales by ``max / (norm + 1e-6)`` where optax scales
by ``max / norm``. :class:`OptaxOptimizer` writes optax's rules out, so
a port run and a JAX run take the same steps from the same state, and
optax's Adam state carries across
(``models/convert.py:adam_state_from_flax``).

A parameter without a gradient is a parameter with a zero gradient, as
under optax; its arithmetic is skipped where that is exact (no moment
state yet, and no weight decay on it), which is the case of the
``fix_*`` frozen parts of the model and of the heads a pretraining task
does not use.

Across ranks (``mesh``, ``parallel/mesh.py``) each update first sums the
gradients over the data group, once per optimizer step (after
``grad_accum``'s mean): a parameter takes part where any rank has its
gradient, so the ones without a gradient stay without one on every rank
alike. Under tensor parallelism the global-norm clip and the LARS trust
ratio take the norm of each whole parameter: the squared norms of the
split parameters (``sharded``) are summed over the model group, the
replicated ones counted once.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.mesh import all_reduce_grads

NAMES = ("adamw", "adam", "rms", "sgd", "radam", "ralamb", "lookahead", "rangerlars")
#: the lookahead names and the fast optimizer each wraps
LOOKAHEAD = {"lookahead": "adam", "rangerlars": "ralamb"}
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.adam / scale_by_radam defaults
RADAM_THRESHOLD = 5.0  # optax.scale_by_radam: rectify once rho_t >= 5
RMS_DECAY, RMS_EPS = 0.9, 1e-8  # optax.rmsprop defaults
# optax.lookahead(sync_period, slow_step_size) as pretrain_src/optim's
# Lookahead and the JAX package's zoo build it
LOOKAHEAD_SYNC, LOOKAHEAD_STEP = 6, 0.5

Schedule = Callable[[int], float]


def _decayed_power(decay: float, count: int) -> np.float32:
    """decay ** count in float32, as optax computes it on its int32 count."""
    return np.power(np.float32(decay), np.float32(count))


def bias_correction(decay: float, count: int) -> float:
    """optax's 1 - decay ** count, in float32."""
    return float(np.float32(1) - _decayed_power(decay, count))


def radam_rectifier(count: int) -> Optional[float]:
    """RAdam's variance rectification r_t at update ``count`` (from 1),
    or None while rho_t < 5, where optax's ``scale_by_radam`` takes the
    bias-corrected momentum unscaled. In float32 as there: rho_t is a
    difference of two numbers near 2000, so its rounding moves r_t by a
    part in a hundred at the first rectified updates."""
    f32 = np.float32
    ro_inf = 2.0 / (1.0 - ADAM_B2) - 1.0
    b2t = _decayed_power(ADAM_B2, count)
    ro = f32(ro_inf) - f32(2 * count) * b2t / (f32(1) - b2t)
    if ro < RADAM_THRESHOLD:
        return None
    return float(np.sqrt((ro - f32(4)) * (ro - f32(2)) * f32(ro_inf)
                         / (f32((ro_inf - 4.0) * (ro_inf - 2.0)) * ro)))


def trust_ratio_(u: torch.Tensor, w: torch.Tensor, wn: Optional[torch.Tensor] = None,
                 un: Optional[torch.Tensor] = None) -> None:
    """The LARS / LAMB trust ratio (the 'lamb' of Ralamb,
    ``vln_hamt_tpu/pretrain/optim.py:scale_by_trust_ratio``): ``u`` scaled
    in place by ||w|| / ||u|| (the norms given, or ``w``'s and ``u``'s),
    or left as it is where either norm is 0. Stays on the device (no host
    read)."""
    wn = torch.linalg.vector_norm(w) if wn is None else wn
    un = torch.linalg.vector_norm(u) if un is None else un
    ratio = torch.where((wn > 0) & (un > 0), wn / un, torch.ones_like(wn))
    u.mul_(ratio)


class OptaxOptimizer(torch.optim.Optimizer):
    """``name`` in adamw | adamW | adam | rms | sgd | radam | ralamb |
    lookahead | rangerlars.

    - ``lr``: a float, or a schedule of the update count (optax's
      ``scale_by_learning_rate``: the k-th update, from 0, takes
      ``lr(k)``).
    - ``weight_decay``: adamw decays every parameter (``optax.adamw``
      without a mask); radam, ralamb and rangerlars decay only the
      parameters in ``decay`` (all when None), before ralamb's trust
      ratio; the others take none.
    - ``grad_clip``: the global-norm clip applied first, or None.
    - ``grad_accum``: ``optax.MultiSteps``: each step() takes one
      micro-batch's gradients into a running mean, and every
      ``grad_accum``-th one updates with it.
    - lookahead and rangerlars: ``optax.lookahead(LOOKAHEAD_SYNC,
      LOOKAHEAD_STEP)`` around adam or ralamb (the accumulation inside
      it): the parameters are the fast weights, the slow ones live in
      the state, and every ``LOOKAHEAD_SYNC``-th step() (micro-batches
      count) moves the slow weights ``LOOKAHEAD_STEP`` of the way to the
      fast and resets the fast to them.
    - ``mesh`` (``parallel/mesh.py:Mesh``): the rank's groups; with it
      the gradients are summed over the data group, and ``sharded``
      names the parameters split over the model group.

    ``state_dict()`` holds the update count, the accumulation and
    lookahead counters and the per-parameter moments (``mu`` for the adam
    family, ``nu`` for it and rms), running mean (``acc``) and slow
    weights (``slow``).
    """

    def __init__(self, params: Iterable[torch.nn.Parameter], name: str,
                 lr: Union[float, Schedule], weight_decay: float = 0.0,
                 grad_clip: Optional[float] = None,
                 decay: Optional[Iterable[torch.nn.Parameter]] = None,
                 grad_accum: int = 1, mesh=None,
                 sharded: Iterable[torch.nn.Parameter] = ()):
        name = "adamw" if name == "adamW" else name
        if name not in NAMES:
            raise ValueError(f"unknown optimizer {name!r}")
        if grad_accum < 1:
            raise ValueError(f"grad_accum {grad_accum} must be >= 1")
        super().__init__(params, {"lr": lr, "count": 0, "mini_step": 0, "since_sync": 0})
        self.name = name
        self.inner = LOOKAHEAD.get(name, name)
        self.lookahead = name in LOOKAHEAD
        self.weight_decay = weight_decay if self.inner in ("adamw", "radam", "ralamb") else 0.0
        self.grad_clip = grad_clip
        self.grad_accum = grad_accum
        self._decayed = (None if decay is None or self.inner == "adamw"
                         else {id(p) for p in decay})
        self.data_group = None if mesh is None else mesh.data_group
        self._data_host_group = None if mesh is None else mesh.data_host_group
        self.model_group = (mesh.model_group if mesh is not None and mesh.model_shards > 1
                            else None)
        self._sharded = {id(p) for p in sharded}
        self._split_masks: Dict[tuple, torch.Tensor] = {}  # by which of the params are split

    def _decays(self, p: torch.Tensor) -> bool:
        return bool(self.weight_decay) and (self._decayed is None or id(p) in self._decayed)

    def _moment(self, p: torch.Tensor, key: str) -> torch.Tensor:
        st = self.state[p]
        if key not in st:
            st[key] = torch.zeros_like(p, memory_format=torch.preserve_format)
        return st[key]

    @staticmethod
    def _lr(group, k: int) -> float:
        lr = group["lr"]
        return float(lr(k)) if callable(lr) else lr

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("OptaxOptimizer.step takes no closure")
        for group in self.param_groups:
            params: List[torch.Tensor] = group["params"]
            if self.grad_accum > 1:
                grads = self._accumulate(group, params)
            else:
                grads = {p: p.grad for p in params if p.grad is not None}
            updates: Dict[torch.Tensor, torch.Tensor] = {}
            if grads is not None and self.data_group is not None:
                grads = self._sum_over_data(params, grads)
            if grads is not None:  # an update is due
                group["count"] += 1
                live = [p for p in params if p in grads or self.state[p].keys() & {"mu", "nu"}
                        or self._decays(p)]
                if live:
                    g = [grads[p] if p in grads else torch.zeros_like(p) for p in live]
                    updates = dict(zip(live, self._update(live, g, group)))
            if self.lookahead:
                self._lookahead(group, params, updates)
            elif updates:
                torch._foreach_add_(list(updates), list(updates.values()))

    def _sum_over_data(self, params, grads) -> Dict[torch.Tensor, torch.Tensor]:
        """The gradients summed over the data group (one bucketed
        all-reduce); a parameter with a gradient on some rank takes a
        zero one where it has none. The presence flags go over gloo on the
        host, so the host does not wait for the device."""
        have = torch.tensor([p in grads for p in params], dtype=torch.int32)
        dist.all_reduce(have, op=dist.ReduceOp.MAX, group=self._data_host_group)
        out = {p: (grads[p] if p in grads else torch.zeros_like(p))
               for p, h in zip(params, have.tolist()) if h}
        all_reduce_grads(list(out.values()), self.data_group)
        return out

    def _sq_norms(self, tensors, params) -> torch.Tensor:
        """Each tensor's squared norm, over the whole parameter: split
        parameters' summed over the model group."""
        sq = torch.stack(torch._foreach_norm(tensors)) ** 2
        key = tuple(id(p) in self._sharded for p in params)
        if not any(key):
            return sq
        mask = self._split_masks.get(key)
        if mask is None:  # copied to the device once per set of parameters
            mask = self._split_masks[key] = torch.tensor(key, device=sq.device)
        part = torch.where(mask, sq, 0.0)
        dist.all_reduce(part, group=self.model_group)
        return torch.where(mask, part, sq)

    def _accumulate(self, group, params) -> Optional[Dict[torch.Tensor, torch.Tensor]]:
        """optax.MultiSteps' running mean (acc += (g - acc) / (n + 1));
        the means when this micro-batch completes an update, else None."""
        n = group["mini_step"]
        for p in params:
            if p.grad is not None:
                acc = self._moment(p, "acc")
                acc.add_((p.grad - acc) / (n + 1))
            elif "acc" in self.state[p]:
                acc = self.state[p]["acc"]
                acc.sub_(acc / (n + 1))
        group["mini_step"] = (n + 1) % self.grad_accum
        if n != self.grad_accum - 1:
            return None
        means = {p: self.state[p]["acc"].clone() for p in params if "acc" in self.state[p]}
        for p in means:
            self.state[p]["acc"].zero_()
        return means

    def _update(self, params, grads, group) -> List[torch.Tensor]:
        """The update of each parameter (what is added to it) from its
        gradient: clip, the optimizer's rule, weight decay, the trust
        ratio, times minus the learning rate."""
        count = group["count"]
        lr = self._lr(group, count - 1)
        if self.grad_clip is not None:
            # optax.clip_by_global_norm: g * max / norm when norm >= max
            if self.model_group is None:
                norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            else:
                norm = self._sq_norms(grads, params).sum().sqrt()
            scale = torch.where(norm < self.grad_clip, 1.0, self.grad_clip / norm)
            grads = torch._foreach_mul(grads, scale)
        if self.inner == "sgd":
            upd = [g.clone() for g in grads]
        elif self.inner == "rms":
            # nu = decay * nu + (1 - decay) * g^2;  g / sqrt(nu + eps)
            nus = [self._moment(p, "nu") for p in params]
            torch._foreach_mul_(nus, RMS_DECAY)
            torch._foreach_addcmul_(nus, grads, grads, value=1.0 - RMS_DECAY)
            denom = torch._foreach_add(nus, RMS_EPS)
            torch._foreach_sqrt_(denom)
            upd = torch._foreach_div(grads, denom)
        else:
            upd = self._adam_family(params, grads, count)
        if self.weight_decay:
            decayed = [i for i, p in enumerate(params) if self._decays(p)]
            if decayed:
                torch._foreach_add_([upd[i] for i in decayed], [params[i] for i in decayed],
                                    alpha=self.weight_decay)
        if self.inner == "ralamb":
            if self.model_group is None:
                for u, p in zip(upd, params):
                    trust_ratio_(u, p)
            else:
                wn, un = self._sq_norms(params, params).sqrt(), self._sq_norms(upd, params).sqrt()
                for i, (u, p) in enumerate(zip(upd, params)):
                    trust_ratio_(u, p, wn[i], un[i])
        torch._foreach_mul_(upd, -lr)
        return upd

    def _adam_family(self, params, grads, count: int) -> List[torch.Tensor]:
        """Bias-corrected moments: mu_hat / (sqrt(nu_hat) + eps) for adam(w),
        and for radam / ralamb r_t times that once rho_t >= 5, mu_hat
        before."""
        mus = [self._moment(p, "mu") for p in params]
        nus = [self._moment(p, "nu") for p in params]
        torch._foreach_mul_(mus, ADAM_B1)
        torch._foreach_add_(mus, grads, alpha=1.0 - ADAM_B1)
        torch._foreach_mul_(nus, ADAM_B2)
        torch._foreach_addcmul_(nus, grads, grads, value=1.0 - ADAM_B2)
        upd = torch._foreach_div(mus, bias_correction(ADAM_B1, count))
        r = radam_rectifier(count) if self.inner in ("radam", "ralamb") else 1.0
        if r is None:
            return upd
        if self.inner in ("radam", "ralamb"):
            torch._foreach_mul_(upd, r)
        denom = torch._foreach_div(nus, bias_correction(ADAM_B2, count))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, ADAM_EPS)
        torch._foreach_div_(upd, denom)
        return upd

    def _lookahead(self, group, params, updates) -> None:
        """optax.lookahead's step: fast += u, except every LOOKAHEAD_SYNC-th
        step, where with d = fast + u - slow the slow weights take
        LOOKAHEAD_STEP * d and the fast ones u - (1 - LOOKAHEAD_STEP) * d."""
        sync = group["since_sync"] == LOOKAHEAD_SYNC - 1
        group["since_sync"] = (group["since_sync"] + 1) % LOOKAHEAD_SYNC
        for p in params:
            st = self.state[p]
            if "slow" not in st:
                st["slow"] = p.detach().clone()
            u = updates.get(p)
            if not sync:
                if u is not None:
                    p.add_(u)
                continue
            diff = p + u - st["slow"] if u is not None else p - st["slow"]
            fast_u = (u if u is not None else torch.zeros_like(p)) - (1 - LOOKAHEAD_STEP) * diff
            st["slow"].add_(LOOKAHEAD_STEP * diff)
            p.add_(fast_u)

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
