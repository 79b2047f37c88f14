"""HAMTAgent (torch): greedy evaluation and R2R training of
``vln_hamt_tpu/agents/agent.py``.

Parity target: ``Seq2SeqCMTAgent`` (``finetune_src/r2r/agent_cmt.py``).
The agent holds the model, the critic and their optimizers, moves the
split's features and nav tables to the device once
(:meth:`HAMTAgent.enable_feature_table`), and evaluates a split greedily
(:meth:`HAMTAgent.eval_split_fast` picks the fastest that applies): as
one device rollout per batch (:meth:`HAMTAgent.eval_split_device`), or
on the host loop, one policy step per device call with the env stepped
on the host in between, lock-step per batch
(:meth:`HAMTAgent.eval_split`, over :meth:`HAMTAgent.interactive_rollout`)
or continuation-packed, a finished slot taking the next item at once
(:meth:`HAMTAgent.eval_split_packed`). The host loop serves the options
the device rollout lacks: features shipped per step (no feature table)
and ``no_cand_backtrack``. The agent trains
(:meth:`HAMTAgent.train_iteration`):

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
  teacher episode forward, then the rollout. Rollout-then-replay (both
  off, or no feature table): a sampling rollout without gradient, on the
  device or the host loop, then the IL loss plus A2C on the recorded
  episode replayed through the teacher-forced forward with the
  rollout's own dropout draws.

Every update clips the navigator's gradient at 40 (agent_cmt.py:597-601).
The task variants ride the same machinery through hooks: the device
rollout's reward and termination (``device_rollout_task``, its cost
slabs from :meth:`HAMTAgent._device_rollout_inputs`), the host loop's
(``_episode_state_init``, ``_pre_env_step``, ``_step_rewards``,
``_update_ended``, ``_env_actions``, ``_teacher_actions``), the packed
evaluator's per-slot episode (``_packed_slot_*``) and the decoded
predictions' extras (``_fetch_decode_extras``, ``_decode_device_extras``);
REVERIE's object grounding (``object_grounding``) threads the object
tables through every path and adds the object CE to the IL loss
(``agents/variants.py``, ``agents/reverie.py``).
Weights come from a seed, from a released reference checkpoint
(:meth:`HAMTAgent.init_from_reference`), from the port's pretraining
(:meth:`HAMTAgent.init_from_pretrain`) or from the agent's own
checkpoint (:meth:`HAMTAgent.save` / :meth:`HAMTAgent.load`, the CLI's
``--resume_file``; :meth:`HAMTAgent.save_dir` writes a directory). The
whole R2R family (r2r, r2r_last, r4r, rxr) runs through this agent and
the R2R reward of the device rollout.

Across ranks (:meth:`HAMTAgent.enable_mesh`, ``parallel/mesh.py``) each
rank trains on its rows of the global batch: every rank's env replica
builds the same global batch and only the rank's rows go to its device,
or (:meth:`HAMTAgent.enable_host_sharded_feed`) the env holds the rank's
shard of the data. Every loss divides by the global count, the sampling
draws its noise at the global batch and takes the rank's lanes, and the
optimizers sum the gradients over the data group, so the ranks together
take the one-rank update. Tensor parallelism splits the model's blocks
over the model group (the critic stays replicated). Evaluation runs on
each rank's own split shard without collectives across data ranks.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import json
import os

import numpy as np
import torch
import torch.distributed as dist

from ..configs import HAMTConfig
from ..data.angle import view_elevation, view_heading
from ..data.feature_db import build_feature_table
from ..data.nav_graph import build_nav_tables
from ..env.observation import EpisodeBatch, ObsBatch
from ..env.r2r_env import R2RNavEnv
from ..eval.metrics import IncrementalNDTW
from ..models.convert import (critic_params_from_flax, load_reference_checkpoint,
                              merge_matching_params, params_from_flax)
from ..models.hamt import init_hamt
from ..models.layers import DropoutRNG, compute_dtype, drop_weight_cache, set_dropout_rng
from ..parallel.mesh import (Mesh, barrier, gather_optimizer_state, gather_state_dict,
                             is_default_process, process_feed_rows, shard_model,
                             shard_optimizer_state, shard_state_dict)
from ..utils.logging import allocator_counts, count, span, sync_span
from .losses import IGNORE_ID, a2c_loss, il_loss
from .optim import OptaxOptimizer
from .packing import PackedILStream
from .rollout import (OBJ_KEYS, build_device_rollout, build_episode_forward,
                      build_packed_il_forward, build_policy_step, build_slot_reset,
                      build_text_row_update)


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
    #: :meth:`eval_split_fast` may take the continuation-packed evaluator
    supports_packed_eval = True
    #: the rollout-then-replay ``sample`` update samples on the device
    #: when the tables are resident (else on the host loop)
    device_rollout_rewards = True
    #: the device rollout's reward and termination
    #: (``rollout.py:build_device_rollout``); the variants override
    device_rollout_task = "r2r"
    #: REVERIE's object grounding: every path plans with ``plan_ref``
    #: over the viewpoint's objects, and the action space appends the
    #: object-stop slot
    object_grounding = False

    def __init__(self, cfg: HAMTConfig, env: Optional[R2RNavEnv] = None,
                 seed: int = 0, device=None):
        self.cfg = cfg
        self.env = env
        self.seed = seed
        self.device = resolve_device(device)
        #: the rank's place among data and tensor-parallel ranks
        #: (:meth:`enable_mesh`); ``_feed_rows`` its rows of the global
        #: batch under the replicated feed, None when it trains on all
        #: its env builds
        self.mesh: Optional[Mesh] = None
        self._feed_rows: Optional[Tuple[int, int]] = None
        self._split_params: List[torch.nn.Parameter] = []
        self._pending_saves: List[Any] = []
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
                                                     ob_type=cfg.env.ob_type,
                                                     objects=self.object_grounding)
        self._feat_table: Optional[torch.Tensor] = None  # (N, V, D)
        self._nav_tables: Optional[Dict[str, torch.Tensor]] = None
        self._obj_tables: Optional[Dict[str, torch.Tensor]] = None  # REVERIE
        self._rollout_cache: Dict[Tuple, Any] = {}
        # observation slots: [C candidates | STOP | views], then under
        # object grounding the object-stop slot, the one stop action
        self.stop_slot = cfg.env.max_candidates
        self.num_ob_tokens = self.stop_slot + 1 + cfg.env.views
        objects = self.object_grounding
        self.stop_action = self.num_ob_tokens if objects else self.stop_slot
        self.num_actions = self.num_ob_tokens + int(objects)
        # the host loop's step functions
        self._policy_step = build_policy_step(self.model, self.critic,
                                              ob_type=cfg.env.ob_type, objects=objects)
        self._slot_reset = build_slot_reset(self.model)
        self._text_row_update = build_text_row_update(self.model)

    def _make_optimizers(self) -> None:
        """Fresh optimizers (no moments, count 0): the optimizer zoo of
        agent_cmt.py:62-77 with optax's rules."""
        tcfg = self.cfg.train
        self.optimizer = OptaxOptimizer(self.model.parameters(), tcfg.optim, tcfg.lr,
                                        tcfg.weight_decay, grad_clip=tcfg.grad_clip,
                                        mesh=self.mesh, sharded=self._split_params)
        self.critic_optimizer = OptaxOptimizer(self.critic.parameters(), tcfg.optim,
                                               tcfg.lr, tcfg.weight_decay, mesh=self.mesh)

    # ------------------------------------------------------------ ranks
    def enable_mesh(self, mesh: Mesh) -> None:
        """Train as this rank of ``mesh`` (the JAX ``enable_mesh``; the
        reference's DDP wrap): each rank's env replica builds the same
        global batch, and the rank trains on its data index's rows of it;
        with ``model_shards`` > 1 the model's blocks are split over the
        model group (``parallel/mesh.py:shard_model``). Dropout draws per
        rank (``Mesh.dropout_streams``). Call before training and before
        :meth:`load`: the optimizers start afresh."""
        if self.cfg.train.batch_size % mesh.data_shards:
            raise ValueError(f"batch {self.cfg.train.batch_size} is not divisible by "
                             f"{mesh.data_shards} data shards")
        self.mesh = mesh
        self._split_params = shard_model(self.model, mesh)
        self._feed_rows = (process_feed_rows(mesh, self.cfg.train.batch_size)
                           if mesh.data_shards > 1 else None)
        self.dropout_rng = DropoutRNG(self.device, self.seed + 17, mesh.dropout_streams)
        set_dropout_rng(self.model, self.dropout_rng)
        set_dropout_rng(self.critic, self.dropout_rng)
        self._weights_changed()
        self._make_optimizers()

    def enable_host_sharded_feed(self) -> None:
        """The env holds this rank's shard of the data and builds only
        the rank's rows (the JAX ``enable_host_sharded_feed``, the
        reference's per-rank DDP loaders): call after :meth:`enable_mesh`
        with ``self.env`` built on ``sel_data_idxs=(data index,
        data_shards)`` at the local batch. The host-loop evaluators keep
        to the rank's own split shard as under the replicated feed."""
        if self.mesh is None:
            raise RuntimeError("enable_mesh first")
        local = self.cfg.train.batch_size // self.mesh.data_shards
        if self.env is not None and self.env.batch_size != local:
            raise ValueError(f"env batch {self.env.batch_size} != this rank's {local} rows")
        self._feed_rows = None

    @property
    def _data_group(self):
        return None if self.mesh is None else self.mesh.data_group

    @property
    def _data_shards(self) -> int:
        return 1 if self.mesh is None else self.mesh.data_shards

    def _rows(self, x, axis: int = 0):
        """This rank's rows of a global-batch array (all of it unless the
        replicated feed splits the batch)."""
        if self._feed_rows is None:
            return x
        start, stop = self._feed_rows
        return x[(slice(None),) * axis + (slice(start, stop),)]

    def _draw_rows(self, b: int, b_il: int = 0) -> Optional[Tuple[int, torch.Tensor]]:
        """The rollout's lanes, [b RL | b_il IL], as rows of the global
        [RL | IL] batch (``rollout.py:gumbel_max``); None on one data rank."""
        n = self._data_shards
        if n == 1:
            return None
        d, dev = self.mesh.data_index, self.device
        idx = [torch.arange(d * b, (d + 1) * b, device=dev)]  # made on the device: no copy
        if b_il:
            idx.append(torch.arange(n * b + d * b_il, n * b + (d + 1) * b_il, device=dev))
        return n * (b + b_il), torch.cat(idx)

    def load_flax_params(self, params: Mapping, cparams: Mapping) -> None:
        """Install the JAX package's flax params (nested dicts of numpy
        arrays) into the model and critic."""
        for module, sd in ((self.model, params_from_flax(params, self.cfg.model)),
                           (self.critic, critic_params_from_flax(cparams))):
            module.load_state_dict(shard_state_dict(
                {k: torch.from_numpy(v) for k, v in sd.items()}, self.mesh), strict=True)
        self._weights_changed()

    def _weights_changed(self) -> None:
        """Free the bf16 weight copies of the old weights (each Linear
        casts anew at its next call; ``models/layers.py:Linear``)."""
        drop_weight_cache(self.model)
        drop_weight_cache(self.critic)

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
        # keyed on the task and the env's horizon and margin, so an eval
        # env with another max_action_len gets its own rollout (JAX
        # agent.py:789-807)
        env = self.env
        key = (self.device_rollout_task, env.max_action_len, float(env.error_margin))
        fn = self._rollout_cache.get(key)
        if fn is None:
            fn = build_device_rollout(self.model, self.critic, env.max_action_len,
                                      ob_type=self.cfg.env.ob_type,
                                      error_margin=env.error_margin,
                                      task=self.device_rollout_task)
            self._rollout_cache[key] = fn
        return fn

    def _device_rollout_args(self, include_rewards: bool = True) -> Dict[str, Any]:
        """Host prep for a device rollout: reset the env and ship the
        instructions, start poses, scan offsets and, with
        ``include_rewards``, the reward's cost slabs under
        ``task_inputs`` (without them, greedy evaluation runs on GT-less
        test splits). A training rollout (``include_rewards``) ships this
        rank's rows only."""
        with span("rollout_inputs"):
            env = self.env
            obs = env.reset()
            offs = np.array([env.feat_offsets[it["scan"]] for it in env.batch], np.int64)
            txt_ids, txt_mask = env.txt_batch()
            ship = self._copy_to_device
            rows = self._rows if include_rewards else (lambda x: x)
            ins = dict(
                txt_ids=ship(torch.as_tensor(rows(txt_ids), dtype=torch.long)),
                txt_mask=ship(torch.as_tensor(rows(txt_mask))),
                start_node=ship(torch.as_tensor(rows(offs + obs.node))),
                start_view=ship(torch.as_tensor(rows(obs.view_index), dtype=torch.long)),
                offs=ship(torch.as_tensor(rows(offs))),
            )
            if include_rewards:
                ins["task_inputs"] = {k: ship(torch.as_tensor(rows(v))) for k, v in
                                      self._device_rollout_inputs(env, obs).items()}
            return ins

    def _goal_cost_slab(self, env, goal_nodes_fn) -> np.ndarray:
        """(B, N_scan_max): each node's distance to the nearest of the
        item's goal nodes, ``goal_nodes_fn(graph, item)`` (JAX
        agent.py:854-864), inf-padded; 0 for an item without one, which
        the task envs observe as always at its goal."""
        slab = np.full((len(env.batch), self._n_scan_max), np.inf, np.float32)
        for i, item in enumerate(env.batch):
            g = env.graphs[item["scan"]]
            goals = goal_nodes_fn(g, item)
            slab[i, : g.num_nodes] = g.dist[:, goals].min(axis=1) if goals else 0.0
        return slab

    def _device_rollout_inputs(self, env, obs) -> Dict[str, np.ndarray]:
        """Per-item cost slabs of the in-loop R2R reward: ``ref_cost``
        (B, N_scan_max, R), each node's distance to each reference node,
        inf-padded, and ``ref_len`` (B,). The variants add or replace
        slabs as their reward reads them."""
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

    # -------------------------------------------------------- host loop
    def _h2d(self, arr: np.ndarray, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """A host array on the device, int32 as int64 indices unless
        ``dtype`` says otherwise. On the card through pinned memory and
        an asynchronous copy: a copy from pageable memory would wait for
        the device's queue, which the packed evaluator's pipelining needs
        to keep running."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        t = t.to(dtype) if dtype is not None else (t.long() if t.dtype == torch.int32 else t)
        count("h2d_bytes", t.nbytes)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _copy_to_device(self, t: torch.Tensor) -> torch.Tensor:
        """A host tensor on the device by a plain copy, which from pageable
        memory waits for the device's queue: a ``sync`` span; its bytes
        count under ``h2d_bytes``."""
        count("h2d_bytes", t.nbytes)
        with sync_span():
            return t.to(self.device)

    @staticmethod
    def _fetch(x: torch.Tensor) -> np.ndarray:
        """``x`` read back to the host, which waits for the device: a
        ``sync`` span."""
        with sync_span():
            return x.cpu().numpy()

    @staticmethod
    def _start_fetch(x: torch.Tensor):
        """Start copying ``x`` to the host; :meth:`_finish_fetch` waits for
        this copy and the work before it, not for work queued later."""
        if x.device.type != "cuda":
            return x, None
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    @staticmethod
    def _finish_fetch(pending) -> np.ndarray:
        host, done = pending
        if done is not None:
            with sync_span():
                done.synchronize()
        return host.numpy()

    def _forbid(self, obs: ObsBatch, visited: List[set], no_cand_backtrack: bool) -> np.ndarray:
        """(B, N) logit mask: with ``no_cand_backtrack`` the candidates
        whose node the episode has visited (agent_cmt.py:342-350)."""
        forbid = np.zeros((obs.batch_size, self.num_actions), bool)
        if no_cand_backtrack:
            for i in range(obs.batch_size):
                for c in range(self.stop_slot):
                    cn = int(obs.cand_node[i, c])
                    if cn >= 0 and cn in visited[i]:
                        forbid[i, c] = True
        return forbid

    def _step_inputs(self, env: R2RNavEnv, obs: ObsBatch, live: np.ndarray,
                     forbid: np.ndarray, given_action: np.ndarray) -> Dict[str, Any]:
        """One policy step's observation on the device, as keyword
        arguments of the policy step: node rows of the resident table
        when the env is in feature-table mode, else the panoramas in the
        compute dtype; under object grounding the object tables, or the
        objects the env observed."""
        ins = {"view_index": self._h2d(obs.view_index), "cand_point": self._h2d(obs.cand_point),
               "cand_ang": self._h2d(obs.cand_ang), "live": self._h2d(live),
               "forbid": self._h2d(forbid), "given_action": self._h2d(given_action)}
        if env.feat_offsets is not None:
            if self._feat_table is None:
                raise RuntimeError("the env is in feature-table mode but the agent has no "
                                   "table (enable_feature_table)")
            offs = np.array([env.feat_offsets[it["scan"]] for it in env.batch], np.int64)
            ins.update(node_idx=self._h2d(offs + obs.node), feat_table=self._feat_table)
            if self.object_grounding:
                ins["obj_tables"] = self._obj_tables
        else:
            ins["pano_feat"] = self._h2d(obs.pano_feat, self._feat_dtype)
            if self.object_grounding:
                ins["objs"] = (self._h2d(obs.obj_fts, self._feat_dtype), self._h2d(obs.obj_angs),
                               self._h2d(obs.obj_pos), self._h2d(obs.obj_mask))
        return ins

    def interactive_rollout(self, mode: str, record_for_replay: bool = False,
                            no_cand_backtrack: bool = False) -> Tuple[List[dict], Dict[str, Any]]:
        """One episode batch of ``self.env`` on the host loop (JAX
        ``interactive_rollout``, agent.py:629-788), without gradient and
        in the modules' train/eval mode: per step one policy step on the
        device, the action read back, the env stepped on the host.

        ``mode``: ``argmax``, ``sample`` (Gumbel-max from ``action_rng``,
        as the device rollout draws) or ``teacher``. Returns
        (trajectories, extras); trajectories follow the reference's
        result schema ``[{instr_id, path: [(vp, heading, elevation)]}]``.
        With ``record_for_replay`` the extras hold what the replay needs:
        ``ep``, the episode padded to ``t_max`` with its final pose, in
        the episode forward's schema; time-major ``rewards`` and
        ``masks``; ``bootstrap_mask``; and ``rollout_logits`` (T_used, B,
        N) of the steps taken.

        The task's rules come from the hooks: the teacher's actions
        (``_teacher_actions``), the env's moves (``_env_actions``), the
        reward (``_step_rewards``), the episode's end (``_update_ended``)
        and per-step bookkeeping before the env moves (``_pre_env_step``;
        under object grounding ``ep_state["obj_logits"]`` holds the
        step's object logits on the device).
        """
        env = self.env
        stop = self.stop_action
        dev = self.device
        obs = env.reset()
        feat_offs = (np.array([env.feat_offsets[it["scan"]] for it in env.batch], np.int64)
                     if env.feat_offsets is not None else None)
        b, t_max = obs.batch_size, env.max_action_len
        txt_ids, txt_mask = env.txt_batch()
        txt_mask_d = self._h2d(txt_mask)
        steps = torch.arange(t_max, device=dev)
        with torch.no_grad():
            txt_embeds = self.model.encode_text(self._h2d(txt_ids), txt_mask_d)
            hist0 = self.model.init_history(b)
            hist_cache = torch.cat([hist0[:, None],
                                    hist0.new_zeros((b, t_max, self.cfg.model.hidden_size))], dim=1)
            hist_len = torch.ones(b, dtype=torch.int32, device=dev)

            graphs = [env.sim.graph(i) for i in range(b)]
            traj = [{"instr_id": env.batch[i]["instr_id"], "path": [self._pose_tuple(env, i)]}
                    for i in range(b)]
            # reward bookkeeping (agent_cmt.py:283-289), the task's
            # mutable episode state for the reward and transition hooks
            ep_state = self._episode_state_init(obs, graphs, traj)
            ended = np.zeros((b,), bool)
            visited = [{int(obs.node[i])} for i in range(b)]
            obs_list: List[ObsBatch] = []
            actions_rec = np.full((b, t_max), stop, np.int32)
            step_mask = np.zeros((b, t_max), bool)
            rewards = np.zeros((t_max, b), np.float32)
            logits_rec: List[torch.Tensor] = []
            for t in range(t_max):
                obs_list.append(obs)
                live = ~ended
                given = (self._teacher_actions(env, obs) if mode == "teacher"
                         else np.zeros((b,), np.int32))
                a_dev, logits, _, hist_cache, hist_len, obj_logits = self._policy_step(
                    txt_embeds, txt_mask_d, hist_cache, hist_len, steps[t], mode=mode,
                    generator=self.action_rng,
                    **self._step_inputs(env, obs, live, self._forbid(obs, visited,
                                                                     no_cand_backtrack), given))
                a_t = self._fetch(a_dev)
                step_mask[:, t] = live
                actions_rec[:, t] = np.where(live, a_t, stop)
                if record_for_replay:
                    logits_rec.append(logits)

                ep_state["obj_logits"] = obj_logits
                self._pre_env_step(t, a_t, live, ended, obs, ep_state, traj)
                env_actions = self._env_actions(a_t, live)
                obs = env.step(env_actions, obs)
                for i in range(b):
                    if env_actions[i] >= 0:
                        traj[i]["path"].append(self._pose_tuple(env, i))
                        visited[i].add(int(obs.node[i]))
                        if "ndtw" in ep_state:
                            ep_state["ndtw"].update(i, int(obs.node[i]))
                if record_for_replay:
                    rewards[t] = self._step_rewards(t, a_t, live, ended, obs, ep_state)
                ended = self._update_ended(ended, a_t, ep_state, train_rl=record_for_replay)
                if ended.all():
                    break

        extras: Dict[str, Any] = {}
        if record_for_replay:
            # padded to t_max, the replay's fixed shape (the reference
            # breaks early per batch, agent_cmt.py:450-451)
            obs_list += [obs_list[-1]] * (t_max - len(obs_list))
            # the replay trains on this rank's rows (the ep's rows are
            # taken in _arrays_to_device)
            extras = {
                "ep": self._stack_obs_episode(obs_list, txt_ids, txt_mask, actions_rec,
                                              step_mask, final_obs=obs, feat_offs=feat_offs),
                "rewards": self._copy_to_device(torch.from_numpy(self._rows(rewards, 1).copy())),
                "masks": self._copy_to_device(torch.from_numpy(
                    self._rows(step_mask.T.astype(np.float32), 1).copy())),
                "bootstrap_mask": self._copy_to_device(torch.from_numpy(self._rows(~ended).copy())),
                "rollout_logits": self._rows(torch.stack(logits_rec), 1),
            }
        return traj, extras

    # Rollout hooks: the R2R reward and termination (agent_cmt.py:407-447);
    # the task-variant agents override them.
    def _teacher_actions(self, env: R2RNavEnv, obs: ObsBatch) -> np.ndarray:
        """The teacher's action slots of a step (STOP off the path)."""
        return np.where(obs.teacher >= 0, obs.teacher, self.stop_slot)

    def _episode_state_init(self, obs: ObsBatch, graphs, traj) -> Dict[str, Any]:
        b = obs.batch_size
        gt_idx = [graphs[i].indices(self.env.batch[i]["path"]) for i in range(b)]
        ndtw = IncrementalNDTW([g.dist for g in graphs], gt_idx, obs.node.tolist())
        return {"ndtw": ndtw, "last_dist": obs.dist_to_goal.copy(),
                "last_ndtw": np.array([ndtw.value(i) for i in range(b)], np.float32)}

    def _pre_env_step(self, t, a_t, live, ended, obs, ep_state, traj) -> None:
        """Called after the action is chosen, before the env moves."""

    def _step_rewards(self, t, a_t, live, ended, obs, ep_state) -> np.ndarray:
        b = len(a_t)
        rewards = np.zeros((b,), np.float32)
        ndtw = ep_state["ndtw"]
        dist = obs.dist_to_goal
        cur_ndtw = np.array([ndtw.value(i) for i in range(b)], np.float32)
        last_dist, last_ndtw = ep_state["last_dist"], ep_state["last_ndtw"]
        for i in range(b):
            if not live[i]:
                continue
            if a_t[i] == self.stop_slot:  # stop (agent_cmt.py:424-428)
                rewards[i] = 2.0 + cur_ndtw[i] * 2.0 if dist[i] < 3.0 else -2.0
            else:
                # sign-quantified fidelity reward (agent_cmt.py:430-438; the
                # reference raises on delta == 0, which equidistant nodes
                # allow: taken as a regress)
                delta = -(dist[i] - last_dist[i])
                nr = cur_ndtw[i] - last_ndtw[i]
                rewards[i] = (1.0 + nr) if delta > 0.0 else (-1.0 + nr)
                # miss-the-target penalty (agent_cmt.py:439-441)
                if last_dist[i] <= 1.0 and dist[i] - last_dist[i] > 0.0:
                    rewards[i] -= (1.0 - last_dist[i]) * 2.0
        ep_state["last_dist"] = dist.copy()
        ep_state["last_ndtw"] = cur_ndtw
        return rewards

    def _update_ended(self, ended, a_t, ep_state, train_rl: bool) -> np.ndarray:
        return ended | (a_t == self.stop_slot)

    # Per-slot hooks of the packed evaluator: R2R-Back's two phases and
    # REVERIE's object grounding ride it through these.
    def _packed_slot_init(self, env: R2RNavEnv, i: int) -> Dict[str, Any]:
        """Fresh per-slot episode state when a slot (re)loads an item."""
        return {}

    def _packed_slot_done(self, st: Dict[str, Any], g: "_PackedEvalGroup", i: int,
                          a_t_i: int, steps: int) -> bool:
        """The episode's end after a policy step; ``steps`` counts its
        policy steps (the lock-step budget, agent_base.py:25-47)."""
        return a_t_i == self.stop_slot or steps >= g.env.max_action_len

    def _packed_slot_result(self, st: Dict[str, Any], pred: dict) -> None:
        """Attach per-slot extras (midstop, predObjId) to a prediction."""

    def _env_actions(self, a_t: np.ndarray, active: np.ndarray) -> np.ndarray:
        """The env's action vector of a step (-1: no move), on the host
        loop and the packed evaluator."""
        return np.where(active & (a_t != self.stop_slot), a_t, -1)

    def _packed_policy_step(self, g: "_PackedEvalGroup", step_ins: Dict[str, Any]):
        """Enqueue one packed policy step without waiting: each slot at its
        own step, clipped at ``t_max - 1`` (JAX agent.py:953-964). Updates
        the group's history and returns (action, aux) on the device, aux
        the object logits under object grounding, else None."""
        t = self._h2d(np.minimum(g.t_vec, g.t_max - 1))
        a_dev, _, _, g.hist_cache, g.hist_len, obj_logits = self._policy_step(
            g.txt_embeds, g.txt_mask, g.hist_cache, g.hist_len, t, mode="argmax", **step_ins)
        return a_dev, obj_logits

    @staticmethod
    def _pose_tuple(env: R2RNavEnv, i: int) -> Tuple[str, float, float]:
        st = env.sim.get_state(i)
        return (env.sim.graph(i).node_ids[st.node], st.heading, st.elevation)

    def _stack_obs_episode(self, obs_list: List[ObsBatch], txt_ids, txt_mask, actions,
                           step_mask, final_obs: Optional[ObsBatch] = None,
                           feat_offs: Optional[np.ndarray] = None,
                           targets: Optional[Dict[str, np.ndarray]] = None
                           ) -> Dict[str, torch.Tensor]:
        """A host-loop episode as the episode forward's device inputs:
        node rows in feature-table mode, else the panoramas (and the
        objects the env observed); with ``final_obs`` the pose after the
        last action (the bootstrap). ``targets`` replace the observed
        ``teacher`` (REVERIE's teacher and object targets)."""
        stack = lambda attr: np.stack([getattr(o, attr) for o in obs_list], axis=1)  # noqa: E731
        d = {"txt_ids": txt_ids, "txt_mask": txt_mask, "view_index": stack("view_index"),
             "cand_point": stack("cand_point"), "cand_ang": stack("cand_ang"),
             "actions": actions, "step_mask": step_mask, "teacher": stack("teacher"),
             **(targets or {})}
        objects = obs_list[0].obj_fts is not None
        if feat_offs is not None:
            d["node_idx"] = np.stack([feat_offs + o.node for o in obs_list], axis=1)
        else:
            d["pano_feat"] = stack("pano_feat")
            if objects:
                d.update({k: stack(k) for k in OBJ_KEYS})
        if final_obs is not None:
            d.update(final_view_index=final_obs.view_index,
                     final_cand_point=final_obs.cand_point, final_cand_ang=final_obs.cand_ang)
            if feat_offs is not None:
                d["final_node_idx"] = feat_offs + final_obs.node
            else:
                d["final_pano_feat"] = final_obs.pano_feat
                if objects:
                    d.update({"final_" + k: getattr(final_obs, k) for k in OBJ_KEYS})
        return self._arrays_to_device(d)

    # ------------------------------------------------------------- eval
    def eval_split(self, env: Optional[R2RNavEnv] = None,
                   no_cand_backtrack: bool = False) -> List[dict]:
        """Greedy full-split evaluation on the host loop, lock-step per
        batch (agent_base.py:25-47): batches until an instr_id repeats,
        the FIRST prediction kept."""
        env = env or self.env
        self.model.eval()
        self.critic.eval()
        old_env, self.env = self.env, env
        try:
            env.reset_epoch(shuffle=False)
            results: Dict[str, dict] = {}
            looped = False
            while not looped:
                trajs, _ = self.interactive_rollout("argmax",
                                                    no_cand_backtrack=no_cand_backtrack)
                for tr in trajs:
                    if tr["instr_id"] in results:
                        looped = True
                    else:
                        results[tr["instr_id"]] = tr
        finally:
            self.env = old_env
        out = []
        for k, v in results.items():
            pred = {"instr_id": k, "trajectory": v["path"]}
            for extra in ("midstop", "predObjId"):
                if extra in v:
                    pred[extra] = v[extra]
            out.append(pred)
        return out

    def eval_split_fast(self, env: Optional[R2RNavEnv] = None,
                        no_cand_backtrack: bool = False) -> List[dict]:
        """The fastest greedy evaluator that applies: the device rollout
        when the tables are resident and ``no_cand_backtrack`` is off (it
        needs the host's visited sets), else the packed evaluator, else
        lock-step. All three give the same predictions (tested)."""
        env = env or self.env
        if (not no_cand_backtrack and self._nav_tables is not None
                and env.feat_offsets is not None):
            return self.eval_split_device(env)
        if self.supports_packed_eval:
            return self.eval_split_packed(env, no_cand_backtrack)
        return self.eval_split(env, no_cand_backtrack)

    def eval_split_packed(self, env: Optional[R2RNavEnv] = None,
                          no_cand_backtrack: bool = False, pipeline: int = 4) -> List[dict]:
        """Continuation-packed greedy evaluation, pipelined (JAX
        agent.py:1316-1372).

        Packing: where the lock-step evaluator idles a slot whose episode
        stopped until the whole batch stops, here a finished slot loads
        the next pending item at once: its history row is reset, its text
        row re-encoded (in chunks of ``min(B, 8)`` rows) and its step
        counter restarted, so every step runs at the full batch.

        Pipelining: the split is dealt to ``pipeline`` groups (at most
        one per full batch of items), each with its own env and history.
        Every group's policy step is enqueued before any action is read,
        so one group's host env step overlaps the others' device work;
        each slot's rows are independent of the others', so the
        predictions equal ``pipeline=1``'s. Each item is predicted once,
        as by :meth:`eval_split`.
        """
        env = env or self.env
        self.model.eval()
        self.critic.eval()
        old_env, self.env = self.env, env
        try:
            items = list(env.data)
            b = env.batch_size
            n_groups = max(1, min(int(pipeline), len(items) // b))
            groups = []
            with torch.no_grad():
                for k in range(n_groups):
                    part = items[k::n_groups]
                    genv = env if k == 0 else env.clone_shell(part)
                    groups.append(_PackedEvalGroup(self, genv, part, no_cand_backtrack))
                while any(g.active.any() for g in groups):
                    for g in groups:  # enqueue every group's step...
                        if g.active.any():
                            g.dispatch()
                    for g in groups:  # ...then read and step one at a time
                        if g.active.any():
                            g.consume()
        finally:
            self.env = old_env
        results: Dict[str, dict] = {}
        for g in groups:
            results.update(g.results)
        return list(results.values())

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
            with span("eval_split_device"):
                fn = self._ensure_device_rollout_fn()
                env.reset_epoch(shuffle=False)
                results: Dict[str, dict] = {}
                looped = False
                while not looped:
                    ins = self._device_rollout_args(include_rewards=False)
                    with span("rollout"), torch.no_grad():
                        ep, extras = fn(ins["txt_ids"], ins["txt_mask"], self._feat_table,
                                        self._nav_tables, ins["start_node"], ins["start_view"],
                                        obj_tables=self._obj_tables)
                    with span("decode"):
                        trajs = self._decode_device_trajectories(env, ep, extras)
                    for tr in trajs:
                        if tr["instr_id"] in results:
                            looped = True
                        else:
                            results[tr["instr_id"]] = tr
        finally:
            self.env = old_env
        return list(results.values())

    def _decode_device_trajectories(self, env, ep, extras) -> List[dict]:
        """Recorded rollout -> eval predictions (host-side), with the
        task's extras (:meth:`_decode_device_extras`)."""
        fetch = self._fetch
        node, view = fetch(ep["node_idx"]), fetch(ep["view_index"])
        actions, mask = fetch(ep["actions"]), fetch(ep["step_mask"])
        fnode, fview = fetch(ep["final_node_idx"]), fetch(ep["final_view_index"])
        extras_np = self._fetch_decode_extras(extras)
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
            pred = {"instr_id": item["instr_id"], "trajectory": path}
            self._decode_device_extras(pred, env, i, node, actions, mask, extras_np)
            out.append(pred)
        return out

    def _fetch_decode_extras(self, extras) -> Dict[str, np.ndarray]:
        """The device extras the per-item decode needs, on the host,
        batch-major, fetched once per batch (the variants override)."""
        return {}

    def _decode_device_extras(self, pred, env, i, node, actions, mask, extras_np) -> None:
        """Per-task prediction extras (midstop, predObjId) from the
        decoded batch's host arrays (the variants override)."""

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
                                                          ob_type=self.cfg.env.ob_type,
                                                          objects=self.object_grounding)
        self.packed_il = True

    def _make_packer(self, env) -> PackedILStream:
        return PackedILStream(env)

    @property
    def _packer(self) -> PackedILStream:
        """The current env's packed-IL stream."""
        packer = self._packers.get(id(self.env))
        if packer is None:
            packer = self._make_packer(self.env)
            self._packers[id(self.env)] = packer
        return packer

    def _pack_to_device(self, pack: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """A host pack -> device tensors (integers as int64 indices); the
        normalizer ``n_episodes`` stays on the host. Every rank builds the
        global pack and takes its slots (all the text rows)."""
        out = {}
        for k, v in pack.items():
            if k == "n_episodes":
                continue
            if k not in ("txt_ids", "txt_mask"):
                v = self._rows(v)
            t = torch.from_numpy(np.ascontiguousarray(v))
            out[k] = self._copy_to_device(t.long() if t.dtype == torch.int32 else t)
        return out

    def _packed_il_loss(self, pack: Dict[str, torch.Tensor], n_episodes: float,
                        weight: float) -> torch.Tensor:
        """The summed CE of the packed forward over the live cells, times
        ``weight / n_episodes``: the estimator of :meth:`_il_loss`, which
        divides by its batch, its episode count (JAX ``_packed_il_loss``,
        agent.py:461-471; REVERIE's dual CE, reverie.py:347-360)."""
        out = self._packed_il_forward(pack, self._feat_table, self._obj_tables)
        logits, obj_logits = out if self.object_grounding else (out, None)
        return self._ce(logits, obj_logits, pack) * weight / n_episodes

    @staticmethod
    def _ce(logits, obj_logits, targets) -> torch.Tensor:
        """The summed CE of time-major logits against batch-major
        ``teacher`` targets, plus under object grounding REVERIE's object
        CE against ``ref_teacher`` (reverie/agent.py:271-275)."""
        loss = il_loss(logits, targets["teacher"].T, IGNORE_ID)
        if obj_logits is not None:
            loss = loss + il_loss(obj_logits, targets["ref_teacher"].T, IGNORE_ID)
        return loss

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
        return self._arrays_to_device(d)

    def _arrays_to_device(self, d: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Host episode arrays (batch-leading) -> device tensors of this
        rank's rows: integers as int64 indices, panorama features in the
        compute dtype."""
        out = {}
        for k, v in d.items():
            t = torch.from_numpy(np.ascontiguousarray(self._rows(v)))
            if k in ("pano_feat", "final_pano_feat", "obj_fts", "final_obj_fts"):
                t = t.to(self._feat_dtype)
            out[k] = self._copy_to_device(t.long() if t.dtype == torch.int32 else t)
        return out

    def _il_loss(self, ep: Dict[str, torch.Tensor], weight: float) -> torch.Tensor:
        """Summed CE of the teacher-forced episode times ``weight / B``
        (``_il_loss``, agent_cmt.py:339,520-521; under object grounding
        REVERIE's dual CE, ``_ref_il_loss``); dropout as the modules'
        train/eval mode says."""
        out = self.episode_forward(ep, self._feat_table, self._obj_tables)
        b = ep["actions"].shape[0] * self._data_shards  # the global batch
        return self._ce(out.logits, out.obj_logits, ep) * weight / b

    def _a2c(self, logits, actions, values, rewards, masks, last_value,
             bootstrap_mask) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """A2C (agent_cmt.py:476-518) on time-major logits and values of
        batch-major ``actions``; the bootstrap only for episodes still
        alive after the horizon (agent_cmt.py:481-484)."""
        tcfg = self.cfg.train
        loss, aux = a2c_loss(logits, actions.T, values, rewards, masks,
                             torch.where(bootstrap_mask, last_value, 0.0),
                             gamma=tcfg.gamma, entropy_weight=tcfg.entropy_loss_weight,
                             normalize=tcfg.normalize_loss, group=self._data_group)
        return loss, {**aux, "RL_loss": loss}

    def _rl_loss(self, ep: Dict[str, torch.Tensor], rewards, masks, bootstrap_mask
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """A2C on a recorded episode (``ep`` with its final pose) replayed
        through the teacher-forced episode forward (``_rl_loss`` of the
        JAX package). The updates differentiate through the rollout
        instead; this replay is their reference."""
        out = self.episode_forward(ep, self._feat_table, self._obj_tables)
        return self._a2c(out.logits, ep["actions"], out.values, rewards, masks,
                         out.last_value, bootstrap_mask)

    def _rollout_a2c(self, ep, extras) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        return self._a2c(extras["rollout_logits"], ep["actions"], extras["values"],
                         extras["rewards"], extras["masks"], extras["last_value"],
                         extras["bootstrap_mask"])

    def _rollout(self, ins: Dict[str, Any], txt_ids, txt_mask, policy: str, il=None):
        """The rollout of ``_device_rollout_args``' batch with rewards and
        the bootstrap value, actions drawn from ``action_rng`` at the
        lanes' global rows."""
        b = ins["start_node"].shape[0]
        return self._ensure_device_rollout_fn()(
            txt_ids, txt_mask, self._feat_table, self._nav_tables, ins["start_node"],
            ins["start_view"], ins["offs"], ins["task_inputs"], policy=policy,
            compute_rewards=True, compute_bootstrap=True, il=il, generator=self.action_rng,
            obj_tables=self._obj_tables,
            draw_rows=self._draw_rows(b, 0 if il is None else il["actions"].shape[0]))

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
        lanes; CE on those lanes' logits over B_il (``_merged_il_loss``;
        REVERIE's dual CE) plus A2C on the RL lanes."""
        il = {k: il_ep[k] for k in ("node_idx", "view_index", "actions", "step_mask")}
        ep, extras = self._rollout(ins, torch.cat([ins["txt_ids"], il_ep["txt_ids"]]),
                                   torch.cat([ins["txt_mask"], il_ep["txt_mask"]]),
                                   "sample", il=il)
        b_il = il_ep["actions"].shape[0] * self._data_shards  # the global batch
        l1 = (self._ce(extras["il_logits"], extras.get("il_obj_logits"), il_ep)
              * self.cfg.train.ml_weight / b_il)
        l2, aux = self._rollout_a2c(ep, extras)
        return l1 + l2, {**aux, "IL_loss": l1}

    def _sample_for_replay(self, use_device: bool):
        """The sampling rollout of the rollout-then-replay update: without
        gradient, in training mode, on the device (``use_device``) or the
        host loop. Returns its recorded episode (with the final pose), its
        extras (rewards, masks, bootstrap mask, logits) and both dropout
        streams' state at its start."""
        self.model.train()
        self.critic.train()
        start = self.dropout_rng.get_state()
        with torch.no_grad():
            if use_device:
                ins = self._device_rollout_args()
                ep, extras = self._ensure_device_rollout_fn()(
                    ins["txt_ids"], ins["txt_mask"], self._feat_table, self._nav_tables,
                    ins["start_node"], ins["start_view"], ins["offs"], ins["task_inputs"],
                    policy="sample", compute_rewards=True, generator=self.action_rng,
                    obj_tables=self._obj_tables,
                    draw_rows=self._draw_rows(ins["start_node"].shape[0]))
            else:
                _, extras = self.interactive_rollout("sample", record_for_replay=True)
                ep = extras["ep"]
        return ep, extras, start

    def _replay_sample_loss(self, il_ep: Dict[str, torch.Tensor], ep: Dict[str, torch.Tensor],
                            extras: Dict[str, torch.Tensor], start
                            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The loss of the rollout-then-replay ``sample`` update (JAX
        ``_il_rl_update_fn``, agent.py:495-514): IL on the teacher episode
        (``ml_weight``) plus :meth:`_rl_loss` on the episode of
        :meth:`_sample_for_replay`.

        The replay draws the rollout's own dropout: both streams of
        ``dropout_rng`` go back to ``start``, where the rollout began, so
        the replay (text, history [CLS], then per step plan, critic and
        history token, in the rollout's order and shapes) repeats its
        masks and attention seeds and takes the gradient under the
        rollout's distribution. The IL episode draws before the rewind,
        and the streams resume after its draws."""
        l1 = self._il_loss(il_ep, self.cfg.train.ml_weight)
        after_il = self.dropout_rng.get_state()
        self.dropout_rng.set_state(start)
        l2, aux = self._rl_loss(ep, extras["rewards"], extras["masks"], extras["bootstrap_mask"])
        self.dropout_rng.set_state(after_il)
        return l1 + l2, {"IL_loss": l1, **aux}

    def _update(self, loss_fn: Callable[[], Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One update: ``loss_fn()`` in training mode, its backward, one
        step of each optimizer (which sum the gradients over the data
        group). Returns the loss and its parts, detached device tensors:
        across data ranks their sums, the global batch's values."""
        self.model.train()
        self.critic.train()
        with span("forward"):
            loss, aux = loss_fn()
        with span("optimizer"):
            self.optimizer.zero_grad(set_to_none=True)
            self.critic_optimizer.zero_grad(set_to_none=True)
        with span("backward"):
            loss.backward()
        with span("optimizer"):
            self.optimizer.step()
            self.critic_optimizer.step()
            self._weights_changed()
        loss, aux = loss.detach(), {k: v.detach() for k, v in aux.items()}
        if self._data_group is not None:
            vals = torch.stack([loss, *aux.values()]).float()
            dist.all_reduce(vals, group=self._data_group)
            loss, aux = vals[0], dict(zip(aux, vals[1:]))
        return loss, aux

    def _teacher_episode(self) -> Dict[str, torch.Tensor]:
        """The env's next teacher-forced episode on the device (REVERIE's
        comes from its own host loop, ``agents/reverie.py``)."""
        return self._ep_to_device(self.env.teacher_episode())

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
        ``sample``: IL (``ml_weight``) plus A2C on a sampling rollout:
        merged or fused through the device rollout as the class
        attributes say, else (both off, or no feature table) rollout then
        replay (:meth:`_replay_sample_loss`). As in the JAX package the
        host takes the teacher episode first, then resets the env for the
        rollout, so one env seed gives the same items.

        With ``sync=False`` the returned scalars are device tensors and
        the host does not wait for the step, so the next episode's host
        work overlaps this one's device work; convert them (float()) at
        logging boundaries only.

        Under an open ``utils.logging.SpanRecorder`` the call is one
        ``train_iteration`` span, with the phases inside it as spans
        (``teacher_episode``, ``rollout_inputs``, ``forward``,
        ``backward``, ``optimizer``) and every wait for the device as a
        ``sync`` span.
        """
        with span("train_iteration"), allocator_counts(self.device):
            return self._train_iteration(feedback, sync)

    def _train_iteration(self, feedback: Optional[str], sync: bool) -> Dict[str, Any]:
        feedback = feedback or self.cfg.train.feedback
        extra = {}
        if feedback == "teacher" and self.packed_il:
            # one packed update; the critic's optimizer steps on zero
            # gradients, as in the unpacked update (weight decay applies)
            with span("teacher_episode"):
                pack = self._packer.next_pack()
                dev_pack = self._pack_to_device(pack)
            extra["episodes"] = int(pack["n_episodes"])
            loss = self._update(lambda: (self._packed_il_loss(
                dev_pack, float(pack["n_episodes"]), self.cfg.train.teacher_weight), {}))[0]
            aux = {"IL_loss": loss}
        elif feedback == "teacher":
            with span("teacher_episode"):
                ep = self._teacher_episode()
            loss = self._il_update(ep, self.cfg.train.teacher_weight)
            aux = {"IL_loss": loss}
        elif feedback == "sample":
            with span("teacher_episode"):
                il_ep = self._teacher_episode()
            use_device = (self.device_rollout_rewards and self._nav_tables is not None
                          and self.env.feat_offsets is not None)
            if use_device and self.merged_sample_update:
                ins = self._device_rollout_args()
                loss, aux = self._update(lambda: self._merged_sample_loss(il_ep, ins))
            elif use_device and self.fused_sample_update:
                ins = self._device_rollout_args()
                loss, aux = self._update(lambda: self._fused_sample_loss(il_ep, ins))
            else:
                rollout = self._sample_for_replay(use_device)
                loss, aux = self._update(lambda: self._replay_sample_loss(il_ep, *rollout))
        else:
            raise ValueError(f"bad feedback {feedback!r}")
        self.step += 1
        if not sync:
            return {"loss": loss, **aux, **extra}
        with sync_span():
            out = {"loss": float(loss)}
        for k, v in aux.items():
            with sync_span():
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
            if module is self.model:  # whole tensors as this rank's blocks
                part = shard_state_dict(part, self.mesh)
            merged, skip = merge_matching_params(module.state_dict(), part)
            module.load_state_dict(merged, strict=True)  # copies, casting
            skipped += [prefix + k for k in skip]
        self._weights_changed()
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
    def _checkpoint(self) -> Dict[str, Any]:
        """Step, model, critic and both optimizer states in the one-rank
        layout (tensor-parallel blocks gathered; every rank takes part)."""
        return {"step": self.step,
                "model": gather_state_dict(self.model.state_dict(), self.mesh),
                "critic": self.critic.state_dict(),
                "optimizer": gather_optimizer_state(self.optimizer.state_dict(), self.model,
                                                    self.mesh),
                "critic_optimizer": self.critic_optimizer.state_dict()}

    def _restore(self, blob: Mapping[str, Any], resume_optimizer: bool) -> int:
        """Install a one-rank-layout checkpoint (split for this rank)."""
        self.model.load_state_dict(shard_state_dict(blob["model"], self.mesh), strict=True)
        self.critic.load_state_dict(blob["critic"], strict=True)
        self._weights_changed()
        if resume_optimizer:
            self.optimizer.load_state_dict(
                shard_optimizer_state(blob["optimizer"], self.model, self.mesh))
            self.critic_optimizer.load_state_dict(blob["critic_optimizer"])
        self.step = int(blob["step"])
        return self.step

    def save(self, path: str) -> None:
        """Model, critic and both optimizer states (``torch.save``), in the
        one-rank layout whatever the mesh: every rank gathers, rank 0
        writes (the JAX ``save``)."""
        blob = self._checkpoint()
        if is_default_process():
            torch.save(blob, path)
        barrier(self.mesh)

    def load(self, path: str, resume_optimizer: bool = False) -> int:
        """Restore a :meth:`save` file or a :meth:`save_dir` directory
        under any mesh; the optimizer states only with
        ``resume_optimizer``. Returns the checkpoint's step."""
        if os.path.isdir(path):
            return self.load_dir(path, resume_optimizer)
        blob = torch.load(path, map_location=self.device, weights_only=True)
        return self._restore(blob, resume_optimizer)

    def save_dir(self, path: str, async_: bool = False) -> None:
        """The :meth:`save` checkpoint as a ``torch.distributed.checkpoint``
        directory (the JAX ``save_orbax``; it cannot read orbax's):
        written by the ranks together, each tensor once. ``async_``
        copies the state to host memory and writes on a background
        thread; :meth:`wait_for_checkpoints` waits for the writes."""
        import torch.distributed.checkpoint as dcp

        self.wait_for_checkpoints()  # one save in flight at a time
        flat = _flatten_checkpoint(self._checkpoint())
        pg = None if self.mesh is None else self.mesh.host_group
        if async_:
            self._pending_saves.append(dcp.async_save(flat, checkpoint_id=path,
                                                      process_group=pg))
        else:
            dcp.save(flat, checkpoint_id=path, process_group=pg)

    def wait_for_checkpoints(self) -> None:
        """Block until every asynchronous :meth:`save_dir` has written."""
        while self._pending_saves:
            self._pending_saves.pop(0).result()

    def load_dir(self, path: str, resume_optimizer: bool = False) -> int:
        """Restore a :meth:`save_dir` directory under any mesh."""
        import torch.distributed.checkpoint as dcp
        from torch.distributed.checkpoint.metadata import TensorStorageMetadata

        meta = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
        flat = {k: (torch.empty(tuple(m.size), dtype=m.properties.dtype)
                    if isinstance(m, TensorStorageMetadata) else None) for k, m in meta.items()}
        dcp.load(flat, checkpoint_id=path,
                 process_group=None if self.mesh is None else self.mesh.host_group)
        blob = _unflatten_checkpoint(flat)
        for part in ("model", "critic"):
            blob[part] = {k: v.to(self.device) for k, v in blob[part].items()}
        return self._restore(blob, resume_optimizer)


class _PackedEvalGroup:
    """One pipeline group of the continuation-packed evaluator (JAX
    agent.py:1567-1717): an env whose batch slots each run their own
    episode, the slots' history and text states on the device, and the
    host bookkeeping. :meth:`dispatch` enqueues one policy step and
    starts the action's copy to the host without waiting for anything;
    :meth:`consume` waits for that copy, steps the env and refills the
    finished slots."""

    def __init__(self, agent: HAMTAgent, env: R2RNavEnv, items: List[dict],
                 no_cand_backtrack: bool):
        self.a = agent
        self.env = env
        self.no_cand_backtrack = no_cand_backtrack
        self.b = b = env.batch_size
        self.t_max = env.max_action_len
        # the first fill through load_item; a split smaller than the batch
        # fills by cycling
        env.batch = [None] * b
        for i in range(b):
            env.load_item(i, items[i % len(items)])
        self.pending = list(items[b:])
        self.pending.reverse()  # pop() from the front of the split order

        txt_ids, txt_mask = env.txt_batch()
        self.txt_mask = agent._h2d(txt_mask)
        self.txt_embeds = agent.model.encode_text(agent._h2d(txt_ids), self.txt_mask)
        # the history cache in the compute dtype (JAX agent.py:1604-1608)
        hist_cache = torch.zeros((b, self.t_max + 1, agent.cfg.model.hidden_size),
                                 dtype=agent._feat_dtype, device=agent.device)
        ones = np.ones((b,), np.int32)
        self.hist_cache, self.hist_len = agent._slot_reset(
            hist_cache, agent._h2d(ones, torch.int32), agent._h2d(ones.astype(bool)))

        self.t_vec = np.zeros((b,), np.int32)  # policy steps of each slot's episode
        self.active = np.ones((b,), bool)
        self.traj = [[agent._pose_tuple(env, i)] for i in range(b)]
        self.visited = [{int(env.sim.node[i])} for i in range(b)]
        self.slot_state = [agent._packed_slot_init(env, i) for i in range(b)]
        self.results: Dict[str, dict] = {}
        self.obs = env._observe()
        self._pending_action = self._pending_aux = self._aux = None

    def dispatch(self) -> None:
        a, obs, b = self.a, self.obs, self.b
        step_ins = a._step_inputs(self.env, obs, self.active.copy(),
                                  a._forbid(obs, self.visited, self.no_cand_backtrack),
                                  np.zeros((b,), np.int32))
        a_dev, aux_dev = a._packed_policy_step(self, step_ins)
        self._pending_action = a._start_fetch(a_dev)
        # the step's aux (object logits) comes back beside the action
        self._pending_aux = None if aux_dev is None else a._start_fetch(aux_dev)
        self._aux = None

    def aux_np(self) -> np.ndarray:
        """The dispatched step's aux on the host (read once, on demand)."""
        if self._aux is None:
            self._aux = self.a._finish_fetch(self._pending_aux)
        return self._aux

    def consume(self) -> None:
        a, env, b = self.a, self.env, self.b
        a_t = a._finish_fetch(self._pending_action)  # waits for this group's step
        self._pending_action = None

        env_actions = a._env_actions(a_t, self.active)
        obs_after = env.step(env_actions, self.obs)
        reset_mask = np.zeros((b,), bool)
        for i in range(b):
            if not self.active[i]:
                continue
            self.t_vec[i] += 1  # the lock-step budget counts policy steps
            if env_actions[i] >= 0:
                self.traj[i].append(a._pose_tuple(env, i))
                self.visited[i].add(int(env.sim.node[i]))
            if not a._packed_slot_done(self.slot_state[i], self, i, int(a_t[i]),
                                       int(self.t_vec[i])):
                continue
            instr_id = env.batch[i]["instr_id"]
            if instr_id not in self.results:
                # a cycled fill's duplicate keeps the first prediction
                pred = {"instr_id": instr_id, "trajectory": self.traj[i]}
                a._packed_slot_result(self.slot_state[i], pred)
                self.results[instr_id] = pred
            if self.pending:
                env.load_item(i, self.pending.pop())
                self.traj[i] = [a._pose_tuple(env, i)]
                self.visited[i] = {int(env.sim.node[i])}
                self.slot_state[i] = a._packed_slot_init(env, i)
                self.t_vec[i] = 0
                reset_mask[i] = True
            else:
                self.active[i] = False
        if not reset_mask.any():
            self.obs = obs_after
            return
        self.hist_cache, self.hist_len = a._slot_reset(self.hist_cache, self.hist_len,
                                                       a._h2d(reset_mask))
        txt_ids, txt_mask = env.txt_batch()
        self.txt_mask = a._h2d(txt_mask)
        # only the reset rows run the text stack, in chunks of a fixed K
        # rows, padded by repeating the chunk's first row (same ids, so the
        # repeated write is of equal values)
        rows = np.nonzero(reset_mask)[0]
        k = min(b, 8)
        for s in range(0, len(rows), k):
            chunk = rows[s:s + k]
            pad = np.full((k,), chunk[0], np.int64)
            pad[: len(chunk)] = chunk
            self.txt_embeds = a._text_row_update(self.txt_embeds, a._h2d(txt_ids[pad]),
                                                 a._h2d(txt_mask[pad]), a._h2d(pad))
        self.obs = env._observe()


def _flatten_checkpoint(blob: Mapping[str, Any]) -> Dict[str, Any]:
    """:meth:`HAMTAgent._checkpoint` as one flat dict of host tensors and
    scalars ("model/<name>", "optimizer/state/<i>/<key>", ...), the form
    ``torch.distributed.checkpoint`` writes and reads without a template
    of the optimizers' state."""
    flat: Dict[str, Any] = {"step": int(blob["step"])}
    for part in ("model", "critic"):
        for k, v in blob[part].items():
            flat[f"{part}/{k}"] = v.detach().to("cpu", copy=True)
    for part in ("optimizer", "critic_optimizer"):
        osd = blob[part]
        flat[f"{part}/param_groups"] = json.dumps(osd["param_groups"])
        for i, st in osd["state"].items():
            for key, v in st.items():
                flat[f"{part}/state/{i}/{key}"] = (v.detach().to("cpu", copy=True)
                                                   if torch.is_tensor(v) else v)
    return flat


def _unflatten_checkpoint(flat: Mapping[str, Any]) -> Dict[str, Any]:
    blob: Dict[str, Any] = {"step": flat["step"], "model": {}, "critic": {},
                            "optimizer": {"state": {}}, "critic_optimizer": {"state": {}}}
    for k, v in flat.items():
        if k == "step":
            continue
        part, rest = k.split("/", 1)
        if part in ("model", "critic"):
            blob[part][rest] = v
        elif rest == "param_groups":
            blob[part]["param_groups"] = json.loads(v)
        else:
            _, i, key = rest.split("/")
            blob[part]["state"].setdefault(int(i), {})[key] = v
    return blob
