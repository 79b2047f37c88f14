"""HAMTAgent (torch): greedy evaluation and IL training of
``vln_hamt_tpu/agents/agent.py``.

Parity target: ``Seq2SeqCMTAgent`` (``finetune_src/r2r/agent_cmt.py``).
The agent holds the model, the critic and their optimizers, moves the
split's features and nav tables to the device once
(:meth:`HAMTAgent.enable_feature_table`), evaluates a split as one
device rollout per batch (:meth:`HAMTAgent.eval_split_device`), and
trains with teacher forcing (:meth:`HAMTAgent.train_iteration`): the
env rolls the ground-truth episode on the host, one teacher-forced
episode forward on the device gives the logits, and the summed CE loss
steps both optimizers, with grad-clip 40 on the navigator only
(agent_cmt.py:597-601). The ``sample`` feedback is ROADMAP items A5-A6.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from ..configs import HAMTConfig
from ..data.angle import view_elevation, view_heading
from ..data.feature_db import build_feature_table
from ..data.nav_graph import build_nav_tables
from ..env.observation import EpisodeBatch
from ..env.r2r_env import R2RNavEnv
from ..models.convert import critic_params_from_flax, params_from_flax
from ..models.hamt import init_hamt
from ..models.layers import DropoutRNG, set_dropout_rng
from .losses import IGNORE_ID, il_loss
from .optim import OptaxOptimizer
from .rollout import build_device_rollout, build_episode_forward


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller asks for another device; raises when
    the requested CUDA device is not there (no silent CPU fallback).

    Also switches TF32 off for matmuls and cuDNN: the port runs fp32,
    and its parity with the JAX package depends on full-precision
    products.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "(--cpu) to run on the CPU")
    return dev


class HAMTAgent:
    def __init__(self, cfg: HAMTConfig, env: Optional[R2RNavEnv] = None,
                 seed: int = 0, device=None):
        self.cfg = cfg
        self.env = env
        self.device = resolve_device(device)
        model, critic = init_hamt(cfg.model, seed)
        self.model = model.to(self.device).eval()
        self.critic = critic.to(self.device).eval()
        # the agent's random streams: dropout masks on the device, the
        # attention kernels' seeds on the host
        self.dropout_rng = DropoutRNG(self.device, seed + 17)
        set_dropout_rng(self.model, self.dropout_rng)
        set_dropout_rng(self.critic, self.dropout_rng)
        # the optimizer zoo of agent_cmt.py:62-77 with optax's rules
        tcfg = cfg.train
        self.optimizer = OptaxOptimizer(self.model.parameters(), tcfg.optim, tcfg.lr,
                                        tcfg.weight_decay, grad_clip=tcfg.grad_clip)
        self.critic_optimizer = OptaxOptimizer(self.critic.parameters(), tcfg.optim,
                                               tcfg.lr, tcfg.weight_decay)
        self.step = 0
        self.logs: Dict[str, List[float]] = defaultdict(list)
        self.episode_forward = build_episode_forward(self.model, self.critic,
                                                     ob_type=cfg.env.ob_type)
        self._feat_table: Optional[torch.Tensor] = None  # (N, V, D)
        self._nav_tables: Optional[Dict[str, torch.Tensor]] = None
        self._rollout_cache: Dict[int, Any] = {}

    def load_flax_params(self, params: Mapping, cparams: Mapping) -> None:
        """Install the JAX package's flax params (nested dicts of numpy
        arrays) into the model and critic."""
        for module, sd in ((self.model, params_from_flax(params, self.cfg.model)),
                           (self.critic, critic_params_from_flax(cparams))):
            module.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                                   strict=True)

    # ------------------------------------------------------------------
    def enable_feature_table(self, env: Optional[R2RNavEnv] = None) -> None:
        """Move the split's (N, V, D) pano features and the nav tables to
        the device and switch the env into node-index mode: the env then
        touches no features on the host, and each rollout step gathers
        its panoramas from the resident table."""
        env = env or self.env
        table, offsets = build_feature_table(env.graphs, env.feat_db)
        self._feat_table = torch.as_tensor(table, device=self.device)
        env.feat_offsets = offsets
        nav, nav_offs = build_nav_tables(env.graphs, self.cfg.env.max_candidates)
        if nav_offs != offsets:
            raise AssertionError("feature and nav tables disagree on scan offsets")
        self._nav_tables = {k: torch.as_tensor(v, device=self.device)
                            for k, v in nav.items()}

    def _ensure_device_rollout_fn(self):
        # keyed on the env's horizon so an eval env with another
        # max_action_len gets its own rollout
        t_max = self.env.max_action_len
        fn = self._rollout_cache.get(t_max)
        if fn is None:
            fn = build_device_rollout(self.model, self.critic, t_max,
                                      ob_type=self.cfg.env.ob_type)
            self._rollout_cache[t_max] = fn
        return fn

    def _device_rollout_args(self, include_rewards: bool = False) -> Dict[str, torch.Tensor]:
        """Host prep for a greedy device rollout: reset the env and ship
        the instructions and start poses."""
        if include_rewards:
            raise NotImplementedError(
                "reward slabs of the sampling rollout are ROADMAP item A5")
        env = self.env
        obs = env.reset()
        offs = np.array([env.feat_offsets[it["scan"]] for it in env.batch], np.int64)
        txt_ids, txt_mask = env.txt_batch()
        dev = self.device
        return dict(
            txt_ids=torch.as_tensor(txt_ids, dtype=torch.long).to(dev),
            txt_mask=torch.as_tensor(txt_mask).to(dev),
            start_node=torch.as_tensor(offs + obs.node).to(dev),
            start_view=torch.as_tensor(obs.view_index, dtype=torch.long).to(dev),
        )

    # ------------------------------------------------------------- eval
    def eval_split_fast(self, env: Optional[R2RNavEnv] = None) -> List[dict]:
        """The fastest greedy evaluator; in the port so far, the device
        rollout (the packed and lock-step host-loop evaluators are
        ROADMAP item A10)."""
        return self.eval_split_device(env)

    def eval_split_device(self, env: Optional[R2RNavEnv] = None) -> List[dict]:
        """Greedy full-split evaluation, one device rollout per batch.

        Iterates batches until an instr_id repeats and keeps the FIRST
        prediction (agent_base.py:25-47); the host only decodes the
        recorded node/view sequences into trajectories.
        """
        env = env or self.env
        if self._nav_tables is None or env.feat_offsets is None:
            raise RuntimeError("device eval needs enable_feature_table()")
        self.model.eval()
        self.critic.eval()
        old_env, self.env = self.env, env
        try:
            fn = self._ensure_device_rollout_fn()
            env.reset_epoch(shuffle=False)
            results: Dict[str, dict] = {}
            looped = False
            while not looped:
                ins = self._device_rollout_args()
                ep, extras = fn(ins["txt_ids"], ins["txt_mask"], self._feat_table,
                                self._nav_tables, ins["start_node"], ins["start_view"])
                for tr in self._decode_device_trajectories(env, ep, extras):
                    if tr["instr_id"] in results:
                        looped = True
                    else:
                        results[tr["instr_id"]] = tr
        finally:
            self.env = old_env
        return list(results.values())

    def _decode_device_trajectories(self, env, ep, extras) -> List[dict]:
        """Recorded rollout -> eval predictions (host-side)."""
        node = ep["node_idx"].cpu().numpy()
        view = ep["view_index"].cpu().numpy()
        actions = ep["actions"].cpu().numpy()
        mask = ep["step_mask"].cpu().numpy()
        fnode = ep["final_node_idx"].cpu().numpy()
        fview = ep["final_view_index"].cpu().numpy()
        b, t_max = node.shape
        c = env.spec.max_candidates  # action < c is a nav move
        out = []
        for i in range(b):
            item = env.batch[i]
            off = env.feat_offsets[item["scan"]]
            g = env.graphs[item["scan"]]

            def pose(n_, v_):
                return (g.node_ids[int(n_) - off],
                        float(view_heading(int(v_))),
                        float(view_elevation(int(v_))))

            path = [pose(node[i, 0], view[i, 0])]
            for t in range(t_max):
                if not mask[i, t]:
                    break
                if actions[i, t] < c:  # nav move: pose after the step
                    nn = node[i, t + 1] if t + 1 < t_max else fnode[i]
                    nv = view[i, t + 1] if t + 1 < t_max else fview[i]
                    path.append(pose(nn, nv))
            out.append({"instr_id": item["instr_id"], "trajectory": path})
        return out

    # ------------------------------------------------------------ train
    def enable_packed_il(self, text_cap: Optional[int] = None) -> None:
        raise NotImplementedError("packed IL is ROADMAP item A9")

    def _ep_to_device(self, ep: EpisodeBatch) -> Dict[str, torch.Tensor]:
        """A host teacher episode -> device tensors of the episode
        forward's schema (``node_idx`` in feature-table mode)."""
        d = {"txt_ids": ep.txt_ids, "txt_mask": ep.txt_mask, "view_index": ep.view_index,
             "cand_point": ep.cand_point, "cand_ang": ep.cand_ang, "actions": ep.actions,
             "step_mask": ep.step_mask, "teacher": ep.teacher}
        if ep.pano_feat is None:
            d["node_idx"] = ep.node_idx
        else:
            d["pano_feat"] = ep.pano_feat
        out = {}
        for k, v in d.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            out[k] = (t.long() if t.dtype == torch.int32 else t).to(self.device)
        return out

    def _il_loss(self, ep: Dict[str, torch.Tensor], weight: float) -> torch.Tensor:
        """Summed CE of the teacher-forced episode times ``weight / B``
        (``_il_loss``, agent_cmt.py:339,520-521); dropout as the modules'
        train/eval mode says."""
        out = self.episode_forward(ep, self._feat_table)
        b = ep["actions"].shape[0]
        return il_loss(out.logits, ep["teacher"].T, IGNORE_ID) * weight / b

    def _il_update(self, ep: Dict[str, torch.Tensor], weight: float) -> torch.Tensor:
        """One IL update (``_il_update_fn``): the loss in training mode,
        one step of each optimizer. Returns the loss (a device scalar)."""
        self.model.train()
        self.critic.train()
        loss = self._il_loss(ep, weight)
        self.optimizer.zero_grad(set_to_none=True)
        self.critic_optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        self.critic_optimizer.step()
        return loss.detach()

    def train_iteration(self, feedback: Optional[str] = None,
                        sync: bool = True) -> Dict[str, Any]:
        """One optimizer step (agent_cmt.py:569-602), ``teacher`` feedback.

        With ``sync=False`` the returned scalars are device tensors and
        the host does not wait for the step, so the next episode's host
        work overlaps this one's device work; convert them (float()) at
        logging boundaries only.
        """
        feedback = feedback or self.cfg.train.feedback
        if feedback == "sample":
            raise NotImplementedError("'sample' feedback (the sampling rollout and the "
                                      "A2C update) is ROADMAP items A5-A6")
        if feedback != "teacher":
            raise ValueError(f"bad feedback {feedback!r}")
        ep = self._ep_to_device(self.env.teacher_episode())
        loss = self._il_update(ep, self.cfg.train.teacher_weight)
        self.step += 1
        aux = {"IL_loss": loss}
        if not sync:
            return {"loss": loss, **aux}
        out = {"loss": float(loss)}
        for k, v in aux.items():
            out[k] = float(v)
            self.logs[k].append(out[k])
        return out

    # ------------------------------------------------------- checkpoints
    def save(self, path: str) -> None:
        """Model, critic and both optimizer states (``torch.save``)."""
        torch.save({"step": self.step,
                    "model": self.model.state_dict(),
                    "critic": self.critic.state_dict(),
                    "optimizer": self.optimizer.state_dict(),
                    "critic_optimizer": self.critic_optimizer.state_dict()}, path)

    def load(self, path: str, resume_optimizer: bool = False) -> int:
        """Restore a :meth:`save` checkpoint; the optimizer states only
        with ``resume_optimizer``. Returns the checkpoint's step."""
        blob = torch.load(path, map_location=self.device, weights_only=True)
        self.model.load_state_dict(blob["model"], strict=True)
        self.critic.load_state_dict(blob["critic"], strict=True)
        if resume_optimizer:
            self.optimizer.load_state_dict(blob["optimizer"])
            self.critic_optimizer.load_state_dict(blob["critic_optimizer"])
        self.step = blob["step"]
        return self.step
