"""HAMTAgent (torch): greedy evaluation and R2R training of
``vln_hamt_tpu/agents/agent.py``.

Parity target: ``Seq2SeqCMTAgent`` (``finetune_src/r2r/agent_cmt.py``).
The agent holds the model, the critic and their optimizers, moves the
split's features and nav tables to the device once
(:meth:`HAMTAgent.enable_feature_table`), evaluates a split as one
device rollout per batch (:meth:`HAMTAgent.eval_split_device`), and
trains (:meth:`HAMTAgent.train_iteration`):

- ``teacher`` feedback: the env rolls the ground-truth episode on the
  host, one teacher-forced episode forward on the device gives the
  logits, and the summed CE loss steps both optimizers; with
  :meth:`HAMTAgent.enable_packed_il` several teacher episodes ride each
  slot of the episode loop back to back (``agents/packing.py``);
- ``sample`` feedback (IL + A2C, agent_cmt.py:569-602): the IL loss of a
  teacher episode plus A2C on a sampling device rollout with in-loop
  nDTW rewards, differentiated through the rollout itself. Merged (the
  CLI's default): the teacher episode rides as extra lanes of the
  rollout, one loop over 2B lanes. Fused (the class default): the
  teacher episode forward, then the rollout.

Every update clips the navigator's gradient at 40 (agent_cmt.py:597-601).
Weights come from a seed, from a released reference checkpoint
(:meth:`HAMTAgent.init_from_reference`), from the port's pretraining
(:meth:`HAMTAgent.init_from_pretrain`) or from the agent's own
checkpoint (:meth:`HAMTAgent.save` / :meth:`HAMTAgent.load`, the CLI's
``--resume_file``). The whole R2R family (r2r, r2r_last, r4r, rxr) runs
through this agent and the R2R reward of the device rollout.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..configs import HAMTConfig
from ..data.angle import view_elevation, view_heading
from ..data.feature_db import build_feature_table
from ..data.nav_graph import build_nav_tables
from ..env.observation import EpisodeBatch
from ..env.r2r_env import R2RNavEnv
from ..models.convert import (critic_params_from_flax, load_reference_checkpoint,
                              merge_matching_params, params_from_flax)
from ..models.hamt import init_hamt
from ..models.layers import DropoutRNG, compute_dtype, set_dropout_rng
from .losses import IGNORE_ID, a2c_loss, il_loss
from .optim import OptaxOptimizer
from .packing import PackedILStream
from .rollout import build_device_rollout, build_episode_forward, build_packed_il_forward


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller asks for another device; raises when
    the requested CUDA device is not there (no silent CPU fallback).

    Also switches TF32 off for matmuls and cuDNN: the fp32 paths' parity
    with the JAX package depends on full-precision products; and keeps
    bf16 products' sums in fp32 (no reduced-precision split-K), as
    XLA's.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "(--cpu) to run on the CPU")
    return dev


class HAMTAgent:
    #: ``sample`` feedback as one update: the IL loss plus the sampling
    #: rollout with its autograd graph, A2C on the rollout's own logits
    #: and values (``_fused_sample_update_fn`` of the JAX package)
    fused_sample_update = True
    #: go further: the teacher episode rides as extra teacher-forced
    #: lanes of the rollout, one loop over B + B_il lanes
    #: (``_merged_sample_update_fn``; the CLI turns it on)
    merged_sample_update = False
    #: ``teacher`` feedback trains on packed episodes (:meth:`enable_packed_il`)
    packed_il = False

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
        # the sampling rollout's actions: a stream of its own, so the
        # dropout draws of the teacher path are the same with or without it
        self.action_rng = torch.Generator(device=self.device).manual_seed(seed + 19)
        self._make_optimizers()
        self.step = 0
        self.logs: Dict[str, List[float]] = defaultdict(list)
        self.episode_forward = build_episode_forward(self.model, self.critic,
                                                     ob_type=cfg.env.ob_type)
        self._feat_table: Optional[torch.Tensor] = None  # (N, V, D)
        self._nav_tables: Optional[Dict[str, torch.Tensor]] = None
        self._rollout_cache: Dict[int, Any] = {}

    def _make_optimizers(self) -> None:
        """Fresh optimizers (no moments, count 0): the optimizer zoo of
        agent_cmt.py:62-77 with optax's rules."""
        tcfg = self.cfg.train
        self.optimizer = OptaxOptimizer(self.model.parameters(), tcfg.optim, tcfg.lr,
                                        tcfg.weight_decay, grad_clip=tcfg.grad_clip)
        self.critic_optimizer = OptaxOptimizer(self.critic.parameters(), tcfg.optim,
                                               tcfg.lr, tcfg.weight_decay)

    def load_flax_params(self, params: Mapping, cparams: Mapping) -> None:
        """Install the JAX package's flax params (nested dicts of numpy
        arrays) into the model and critic."""
        for module, sd in ((self.model, params_from_flax(params, self.cfg.model)),
                           (self.critic, critic_params_from_flax(cparams))):
            module.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                                   strict=True)

    # ------------------------------------------------------------------
    def enable_feature_table(self, env: Optional[R2RNavEnv] = None) -> None:
        """Move the split's (N, V, D) pano features, in the compute dtype
        (bf16 halves the table), and the nav tables to the device and
        switch the env into node-index mode: the env then touches no
        features on the host, and each rollout step gathers its panoramas
        from the resident table."""
        env = env or self.env
        table, offsets = build_feature_table(env.graphs, env.feat_db)
        self._feat_table = torch.as_tensor(table).to(self.device, self._feat_dtype)
        env.feat_offsets = offsets
        nav, nav_offs = build_nav_tables(env.graphs, self.cfg.env.max_candidates)
        if nav_offs != offsets:
            raise AssertionError("feature and nav tables disagree on scan offsets")
        self._nav_tables = {k: torch.as_tensor(v, device=self.device)
                            for k, v in nav.items()}
        # the reward's cost slabs: (B, nodes of the largest scan, longest
        # reference path)
        self._n_scan_max = max(g.num_nodes for g in env.graphs.values())
        self._ref_max = max((len(it["path"]) for it in env.data if "path" in it),
                            default=2)

    def _ensure_device_rollout_fn(self):
        # keyed on the env's horizon and margin so an eval env with
        # another max_action_len gets its own rollout
        env = self.env
        key = (env.max_action_len, float(env.error_margin))
        fn = self._rollout_cache.get(key)
        if fn is None:
            fn = build_device_rollout(self.model, self.critic, env.max_action_len,
                                      ob_type=self.cfg.env.ob_type,
                                      error_margin=env.error_margin,
                                      # the R2R family (r2r, r2r_last, r4r,
                                      # rxr) shares the R2R reward
                                      task="r2r")
            self._rollout_cache[key] = fn
        return fn

    def _device_rollout_args(self, include_rewards: bool = True) -> Dict[str, Any]:
        """Host prep for a device rollout: reset the env and ship the
        instructions, start poses, scan offsets and, with
        ``include_rewards``, the reward's cost slabs under
        ``task_inputs`` (without them, greedy evaluation runs on GT-less
        test splits)."""
        env = self.env
        obs = env.reset()
        offs = np.array([env.feat_offsets[it["scan"]] for it in env.batch], np.int64)
        txt_ids, txt_mask = env.txt_batch()
        dev = self.device
        ins = dict(
            txt_ids=torch.as_tensor(txt_ids, dtype=torch.long).to(dev),
            txt_mask=torch.as_tensor(txt_mask).to(dev),
            start_node=torch.as_tensor(offs + obs.node).to(dev),
            start_view=torch.as_tensor(obs.view_index, dtype=torch.long).to(dev),
            offs=torch.as_tensor(offs).to(dev),
        )
        if include_rewards:
            ins["task_inputs"] = {k: torch.as_tensor(v).to(dev) for k, v in
                                  self._device_rollout_inputs(env, obs).items()}
        return ins

    def _device_rollout_inputs(self, env, obs) -> Dict[str, np.ndarray]:
        """Per-item cost slabs of the in-loop R2R reward: ``ref_cost``
        (B, N_scan_max, R), each node's distance to each reference node,
        inf-padded, and ``ref_len`` (B,)."""
        b = obs.batch_size
        # the split's longest path sizes the slab; an env that shares the
        # table (the aug env beside the train env) may hold longer ones
        r_max = max([self._ref_max] + [len(it["path"]) for it in env.batch])
        ref_cost = np.full((b, self._n_scan_max, r_max), np.inf, np.float32)
        ref_len = np.zeros((b,), np.int32)
        for i, item in enumerate(env.batch):
            g = env.graphs[item["scan"]]
            ref = g.indices(item["path"])
            ref_len[i] = len(ref)
            ref_cost[i, : g.num_nodes, : len(ref)] = g.dist[:, ref]
        return {"ref_cost": ref_cost, "ref_len": ref_len}

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
                ins = self._device_rollout_args(include_rewards=False)
                with torch.no_grad():
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
    def enable_packed_il(self) -> None:
        """Pack teacher episodes densely into the IL episode loop
        (``agents/packing.py``): several episodes ride each slot back to
        back, so the fixed-T loop stops paying for episode padding (about
        T / mean length more episodes per update at R2R lengths) with the
        same per-episode estimator. Needs feature-table transport
        (:meth:`enable_feature_table` first); changes
        ``train_iteration('teacher')`` only. One packer per env object,
        made when the agent first trains on it, so GT/aug alternation
        keeps each env's episode queue apart (JAX ``enable_packed_il``,
        agent.py:212-262)."""
        if self._feat_table is None or self.env.feat_offsets is None:
            raise ValueError("packed IL needs feature-table transport (enable_feature_table)")
        self._packers: Dict[int, PackedILStream] = {}
        self._packed_il_forward = build_packed_il_forward(self.model,
                                                          ob_type=self.cfg.env.ob_type)
        self.packed_il = True

    @property
    def _packer(self) -> PackedILStream:
        """The current env's packed-IL stream."""
        packer = self._packers.get(id(self.env))
        if packer is None:
            packer = PackedILStream(self.env)
            self._packers[id(self.env)] = packer
        return packer

    def _pack_to_device(self, pack: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """A host pack -> device tensors (integers as int64 indices); the
        normalizer ``n_episodes`` stays on the host."""
        out = {}
        for k, v in pack.items():
            if k == "n_episodes":
                continue
            t = torch.from_numpy(np.ascontiguousarray(v))
            out[k] = (t.long() if t.dtype == torch.int32 else t).to(self.device)
        return out

    def _packed_il_loss(self, pack: Dict[str, torch.Tensor], n_episodes: float,
                        weight: float) -> torch.Tensor:
        """The summed CE of the packed forward over the live cells, times
        ``weight / n_episodes``: the estimator of :meth:`_il_loss`, which
        divides by its batch, its episode count (JAX ``_packed_il_loss``,
        agent.py:461-471)."""
        logits = self._packed_il_forward(pack, self._feat_table)
        return il_loss(logits, pack["teacher"].T, IGNORE_ID) * weight / n_episodes

    @property
    def _feat_dtype(self) -> torch.dtype:
        return compute_dtype(self.cfg.model)

    def _ep_to_device(self, ep: EpisodeBatch) -> Dict[str, torch.Tensor]:
        """A host teacher episode -> device tensors of the episode
        forward's schema (``node_idx`` in feature-table mode; panorama
        features cast to the compute dtype at the boundary, as the JAX
        package's ``episode_to_device``)."""
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
            if k == "pano_feat":
                t = t.to(self._feat_dtype)
            out[k] = (t.long() if t.dtype == torch.int32 else t).to(self.device)
        return out

    def _il_loss(self, ep: Dict[str, torch.Tensor], weight: float) -> torch.Tensor:
        """Summed CE of the teacher-forced episode times ``weight / B``
        (``_il_loss``, agent_cmt.py:339,520-521); dropout as the modules'
        train/eval mode says."""
        out = self.episode_forward(ep, self._feat_table)
        b = ep["actions"].shape[0]
        return il_loss(out.logits, ep["teacher"].T, IGNORE_ID) * weight / b

    def _a2c(self, logits, actions, values, rewards, masks, last_value,
             bootstrap_mask) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """A2C (agent_cmt.py:476-518) on time-major logits and values of
        batch-major ``actions``; the bootstrap only for episodes still
        alive after the horizon (agent_cmt.py:481-484)."""
        tcfg = self.cfg.train
        loss, aux = a2c_loss(logits, actions.T, values, rewards, masks,
                             torch.where(bootstrap_mask, last_value, 0.0),
                             gamma=tcfg.gamma, entropy_weight=tcfg.entropy_loss_weight,
                             normalize=tcfg.normalize_loss)
        return loss, {**aux, "RL_loss": loss}

    def _rl_loss(self, ep: Dict[str, torch.Tensor], rewards, masks, bootstrap_mask
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """A2C on a recorded episode (``ep`` with its final pose) replayed
        through the teacher-forced episode forward (``_rl_loss`` of the
        JAX package). The updates differentiate through the rollout
        instead; this replay is their reference."""
        out = self.episode_forward(ep, self._feat_table)
        return self._a2c(out.logits, ep["actions"], out.values, rewards, masks,
                         out.last_value, bootstrap_mask)

    def _rollout_a2c(self, ep, extras) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        return self._a2c(extras["rollout_logits"], ep["actions"], extras["values"],
                         extras["rewards"], extras["masks"], extras["last_value"],
                         extras["bootstrap_mask"])

    def _rollout(self, ins: Dict[str, Any], txt_ids, txt_mask, policy: str, il=None):
        """The rollout of ``_device_rollout_args``' batch with rewards and
        the bootstrap value, actions drawn from ``action_rng``."""
        return self._ensure_device_rollout_fn()(
            txt_ids, txt_mask, self._feat_table, self._nav_tables, ins["start_node"],
            ins["start_view"], ins["offs"], ins["task_inputs"], policy=policy,
            compute_rewards=True, compute_bootstrap=True, il=il, generator=self.action_rng)

    def _fused_sample_loss(self, il_ep: Dict[str, torch.Tensor], ins: Dict[str, Any],
                           policy: str = "sample"
                           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The loss of the fused ``sample`` update: IL on the teacher
        episode (``ml_weight``) plus A2C on the rollout's own logits and
        values. ``policy="argmax"`` draws nothing (tests)."""
        l1 = self._il_loss(il_ep, self.cfg.train.ml_weight)
        l2, aux = self._rollout_a2c(*self._rollout(ins, ins["txt_ids"], ins["txt_mask"],
                                                   policy))
        return l1 + l2, {"IL_loss": l1, **aux}

    def _merged_sample_loss(self, il_ep: Dict[str, torch.Tensor], ins: Dict[str, Any]
                            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The loss of the merged ``sample`` update: one sampling rollout
        over the RL lanes plus the teacher episode as teacher-forced
        lanes; CE on those lanes' logits over B_il (``_merged_il_loss``)
        plus A2C on the RL lanes."""
        il = {k: il_ep[k] for k in ("node_idx", "view_index", "actions", "step_mask")}
        ep, extras = self._rollout(ins, torch.cat([ins["txt_ids"], il_ep["txt_ids"]]),
                                   torch.cat([ins["txt_mask"], il_ep["txt_mask"]]),
                                   "sample", il=il)
        b_il = il_ep["actions"].shape[0]
        l1 = (il_loss(extras["il_logits"], il_ep["teacher"].T, IGNORE_ID)
              * self.cfg.train.ml_weight / b_il)
        l2, aux = self._rollout_a2c(ep, extras)
        return l1 + l2, {**aux, "IL_loss": l1}

    def _update(self, loss_fn: Callable[[], Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One update: ``loss_fn()`` in training mode, its backward, one
        step of each optimizer. Returns the loss and its parts, detached
        device tensors."""
        self.model.train()
        self.critic.train()
        loss, aux = loss_fn()
        self.optimizer.zero_grad(set_to_none=True)
        self.critic_optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        self.critic_optimizer.step()
        return loss.detach(), {k: v.detach() for k, v in aux.items()}

    def _il_update(self, ep: Dict[str, torch.Tensor], weight: float) -> torch.Tensor:
        """One IL update (``_il_update_fn``). Returns the loss (a device
        scalar)."""
        return self._update(lambda: (self._il_loss(ep, weight), {}))[0]

    def train_iteration(self, feedback: Optional[str] = None,
                        sync: bool = True) -> Dict[str, Any]:
        """One optimizer step (agent_cmt.py:569-602).

        ``teacher``: IL on the env's teacher episode (``teacher_weight``),
        or with :meth:`enable_packed_il` on the next pack, whose episode
        count the result carries under ``episodes`` (a host int).
        ``sample``: IL (``ml_weight``) plus A2C on a sampling device
        rollout, merged or fused as the class attributes say. As in the
        JAX package the host takes the teacher episode first, then resets
        the env for the rollout, so one env seed gives the same items.

        With ``sync=False`` the returned scalars are device tensors and
        the host does not wait for the step, so the next episode's host
        work overlaps this one's device work; convert them (float()) at
        logging boundaries only.
        """
        feedback = feedback or self.cfg.train.feedback
        extra = {}
        if feedback == "teacher" and self.packed_il:
            # one packed update; the critic's optimizer steps on zero
            # gradients, as in the unpacked update (weight decay applies)
            pack = self._packer.next_pack()
            extra["episodes"] = int(pack["n_episodes"])
            dev_pack = self._pack_to_device(pack)
            loss = self._update(lambda: (self._packed_il_loss(
                dev_pack, float(pack["n_episodes"]), self.cfg.train.teacher_weight), {}))[0]
            aux = {"IL_loss": loss}
        elif feedback == "teacher":
            ep = self._ep_to_device(self.env.teacher_episode())
            loss = self._il_update(ep, self.cfg.train.teacher_weight)
            aux = {"IL_loss": loss}
        elif feedback == "sample":
            if (self._nav_tables is None or self.env.feat_offsets is None
                    or not (self.merged_sample_update or self.fused_sample_update)):
                raise NotImplementedError(
                    "'sample' feedback without the device rollout (rollout-then-replay "
                    "over the host-loop rollout) is ROADMAP item A10")
            il_ep = self._ep_to_device(self.env.teacher_episode())
            ins = self._device_rollout_args()
            if self.merged_sample_update:
                loss, aux = self._update(lambda: self._merged_sample_loss(il_ep, ins))
            else:
                loss, aux = self._update(lambda: self._fused_sample_loss(il_ep, ins))
        else:
            raise ValueError(f"bad feedback {feedback!r}")
        self.step += 1
        if not sync:
            return {"loss": loss, **aux, **extra}
        out = {"loss": float(loss)}
        for k, v in aux.items():
            out[k] = float(v)
            self.logs[k].append(out[k])
        return {**out, **extra}

    # --------------------------------------------- weight initialization
    def _install_params(self, partial: Mapping[str, torch.Tensor],
                        critic_partial: Optional[Mapping[str, torch.Tensor]] = None
                        ) -> List[str]:
        """Merge (possibly partial) state dicts over the current weights by
        name and shape (the reference's strict=False ``from_pretrained``
        load, vlnbert_init.py:64-67), cast to the parameters' types on
        their device. Both optimizers start fresh (a new fine-tuning run);
        the step count stays. Returns the skipped names, the critic's
        under ``critic.``."""
        skipped: List[str] = []
        for module, part, prefix in ((self.model, partial, ""),
                                     (self.critic, critic_partial, "critic.")):
            if part is None:
                continue
            merged, skip = merge_matching_params(module.state_dict(), part)
            module.load_state_dict(merged, strict=True)  # copies, casting
            skipped += [prefix + k for k in skip]
        self._make_optimizers()
        return skipped

    def init_from_reference(self, path: str) -> List[str]:
        """Initialize from a released reference torch checkpoint: an agent
        save (agent_cmt.py:607-622; critic included) or a pretrain
        ModelSaver state dict (the ``--bert_ckpt_file`` files). Call
        before :meth:`load`, so a resumed checkpoint wins. Returns the
        skipped names."""
        return self._install_params(*load_reference_checkpoint(path))

    # a checkpoint of the port's run/pretrain.py is a reference pretrain
    # ModelSaver file: the bert.* trunk, and the SAP head next_action,
    # whose names are the action head's, so it grafts onto it (the JAX
    # package's pretrain_to_finetune_params); the other heads are dropped
    init_from_pretrain = init_from_reference

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
