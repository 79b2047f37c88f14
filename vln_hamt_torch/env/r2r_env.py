"""R2R-family task environment.

Parity target: ``R2RBatch`` (``finetune_src/r2r/env.py:80-386``) —
minibatching with shuffle-wraparound, per-step observations, fixed-step
teacher actions, and the metric suite — rebuilt on the vectorized
:class:`GraphSimulator` with dense per-scan tables and fixed-shape
:class:`ObsBatch` outputs.

Key structural change: :meth:`teacher_episode` rolls the whole
teacher-forced episode on the host in one go and returns a time-stacked
:class:`EpisodeBatch`, so IL training is a single device call instead of
``max_action_len`` Python/GPU round trips.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..data.feature_db import FeatureDB
from ..data.nav_graph import NavGraph
from ..eval.metrics import aggregate_metrics, eval_r2r_item
from .observation import IGNORE_ID, EpisodeBatch, ObsBatch, ObsSpec, make_obs_batch
from .sim import GraphSimulator


class R2RNavEnv:
    def __init__(
        self,
        graphs: Dict[str, NavGraph],
        feat_db: FeatureDB,
        instr_data: List[dict],
        spec: ObsSpec,
        batch_size: int = 8,
        max_instr_len: int = 60,
        max_action_len: int = 15,
        seed: int = 0,
        name: Optional[str] = None,
        sel_data_idxs: Optional[Tuple[int, int]] = None,
        error_margin: float = 3.0,
        reuse_episode_buffers: bool = False,
    ):
        self.graphs = graphs
        self.feat_db = feat_db
        self.spec = spec
        self.batch_size = batch_size
        self.max_instr_len = max_instr_len
        self.max_action_len = max_action_len
        self.name = name
        self.error_margin = error_margin
        # Perf knob for the training loop: recycle the big (B,T,V,D)
        # pano-feature episode buffer through a 4-deep ring instead of
        # allocating a fresh buffer per episode. Safe when every
        # EpisodeBatch is consumed within 3 subsequent collect calls;
        # leave off for code that holds episodes longer.
        self.reuse_episode_buffers = reuse_episode_buffers
        self._pano_ring: Dict[tuple, list] = {}
        self._pano_ring_idx = 0
        # extra ctor kwargs a subclass needs clone_shell to forward
        self._clone_extra: Dict[str, object] = {}
        # feature-table mode (set via agent.enable_feature_table):
        # scan -> row offset into the device-resident (N, V, D) feature
        # table. When set, the env NEVER touches features on the host —
        # observations carry pano_feat=None and episodes carry global
        # node indices for an on-device gather.
        self.feat_offsets: Optional[Dict[str, int]] = None

        self.data = list(instr_data)
        # ground truth over the FULL split, before rank sharding
        # (env.py:92-93): evaluation joins sharded predictions later.
        self.gt_trajs = self._get_gt_trajs(self.data)
        if sel_data_idxs is not None:  # rank-sharded validation (env.py:96-104)
            t_split, n_splits = sel_data_idxs
            per = len(self.data) // n_splits
            start = per * t_split
            end = None if t_split == n_splits - 1 else start + per
            self.data = self.data[start:end]

        self._rng = random.Random(seed)
        self._rng.shuffle(self.data)
        self.ix = 0
        self.sim = GraphSimulator(graphs, batch_size)
        self.batch: List[dict] = []
        self._t = 0

    # ------------------------------------------------------------------
    def _get_gt_trajs(self, data: List[dict]) -> Dict[str, tuple]:
        """Overridable GT extraction (cvdn/env.py:28-29 overrides)."""
        return {x["instr_id"]: (x["scan"], x["path"]) for x in data
                if "path" in x}

    def size(self) -> int:
        return len(self.data)

    def _next_minibatch(self, batch_size: Optional[int] = None) -> None:
        """Shuffle-wraparound minibatching (env.py:149-165)."""
        bs = batch_size or self.batch_size
        batch = self.data[self.ix : self.ix + bs]
        if len(batch) < bs:
            self._rng.shuffle(self.data)
            self.ix = bs - len(batch)
            batch += self.data[: self.ix]
        else:
            self.ix += bs
        self.batch = batch

    def reset_epoch(self, shuffle: bool = False) -> None:
        if shuffle:
            self._rng.shuffle(self.data)
        self.ix = 0

    # ------------------------------------------------------------------
    def _item_goal(self, item: dict) -> int:
        return self.graphs[item["scan"]].index(item["path"][-1])

    def _teacher_node(self, i: int) -> int:
        """Fixed-step teacher (env.py:254-268 with t): path[t+1] while on
        the ground-truth schedule, else STAY (current node)."""
        item = self.batch[i]
        g = self.graphs[item["scan"]]
        path = item["path"]
        if self._t < len(path) - 1:
            return g.index(path[self._t + 1])
        return int(self.sim.node[i])

    def _observe(self, pano_out: np.ndarray = None) -> ObsBatch:
        b = len(self.batch)
        if self.feat_offsets is not None:
            feats = None
        else:
            feats = [
                self.feat_db.get(self.batch[i]["scan"],
                                 self.sim.graph(i).node_ids[self.sim.node[i]])
                for i in range(b)
            ]
        goals = [self._item_goal(it) for it in self.batch]
        teacher_nodes = [self._teacher_node(i) for i in range(b)]
        return make_obs_batch(self.spec, self.sim, feats, goals, teacher_nodes,
                              pano_out=pano_out)

    def load_item(self, slot: int, item: dict) -> None:
        """Swap one slot's episode in place (continuation-packed eval)."""
        self.batch[slot] = item
        self.sim.new_episode_at(slot, item["scan"], item["path"][0],
                                item.get("heading", 0.0))

    def clone_shell(self, items: List[dict], seed: int = 0) -> "R2RNavEnv":
        """A second env of the same class/config over a different item
        list. Pipelined packed evaluation drives two such groups so one
        group's host/env work overlaps the other's device step."""
        env = type(self)(
            self.graphs, self.feat_db, items, self.spec,
            batch_size=self.batch_size, max_instr_len=self.max_instr_len,
            max_action_len=self.max_action_len, seed=seed, name=self.name,
            error_margin=self.error_margin, **self._clone_extra,
        )
        env.feat_offsets = self.feat_offsets  # same graphs, same table
        return env

    def reset(self) -> ObsBatch:
        self._next_minibatch()
        self.sim.new_episodes(
            [it["scan"] for it in self.batch],
            [it["path"][0] for it in self.batch],
            [it.get("heading", 0.0) for it in self.batch],
        )
        self._t = 0
        return self._observe()

    def step(self, actions: np.ndarray, obs: ObsBatch,
             pano_out: np.ndarray = None) -> ObsBatch:
        """Apply action slots; -1 or the STOP slot is a no-op.

        ``actions`` index into ``obs.cand_node``/``obs.cand_view``.
        """
        stop = self.spec.stop_slot
        for i in range(len(self.batch)):
            a = int(actions[i])
            if a < 0 or a >= stop:
                continue
            tgt = int(obs.cand_node[i, a])
            assert tgt >= 0, f"slot {i}: padded candidate {a} selected"
            self.sim.move(i, tgt, int(obs.cand_view[i, a]))
        self._t += 1
        return self._observe(pano_out=pano_out)

    # ------------------------------------------------------------------
    def txt_batch(self) -> Tuple[np.ndarray, np.ndarray]:
        """(B, L) padded instruction ids + mask for the current batch."""
        b = len(self.batch)
        ids = np.zeros((b, self.max_instr_len), dtype=np.int32)
        mask = np.zeros((b, self.max_instr_len), dtype=bool)
        for i, item in enumerate(self.batch):
            enc = item["instr_encoding"][: self.max_instr_len]
            ids[i, : len(enc)] = enc
            mask[i, : len(enc)] = True
        return ids, mask

    def teacher_episode(self) -> EpisodeBatch:
        """Roll a full teacher-forced episode; one EpisodeBatch out.

        The trajectory under teacher forcing is the ground-truth path, so
        every step's observation is known without model involvement.
        In feature-table mode no features are touched on the host at
        all — the episode carries node indices for a device gather.
        """
        obs = self.reset()
        return self._collect_episode_with_actions(obs, policy=None)

    def _collect_episode_with_actions(self, obs: ObsBatch, policy) -> EpisodeBatch:
        b = len(self.batch)
        t_max = self.max_action_len
        stop = self.spec.stop_slot
        c = self.spec.max_candidates
        a_dim = self.spec.angle_feat_size
        table_mode = obs.pano_feat is None

        if table_mode:
            ep_pano = None
            ep_node = np.empty((b, t_max), np.int32)
            offs = np.array([self.feat_offsets[it["scan"]]
                             for it in self.batch], np.int64)
        else:
            v, d = obs.pano_feat.shape[1:]
            # preallocated episode buffers; env.step writes pano features
            # straight into ep_pano[:, t] (no per-step ObsBatch list +
            # final np.stack re-copy of the 50+ MB feature tensor)
            if self.reuse_episode_buffers:
                ring = self._pano_ring.setdefault((b, t_max, v, d),
                                                  [None] * 4)
                self._pano_ring_idx = (self._pano_ring_idx + 1) % 4
                if ring[self._pano_ring_idx] is None:
                    ring[self._pano_ring_idx] = np.empty((b, t_max, v, d),
                                                         np.float32)
                ep_pano = ring[self._pano_ring_idx]
            else:
                ep_pano = np.empty((b, t_max, v, d), np.float32)
            ep_node = None
        ep_view = np.empty((b, t_max), np.int32)
        ep_cpoint = np.empty((b, t_max, c), np.int32)
        ep_cang = np.empty((b, t_max, c, a_dim), np.float32)
        actions = np.full((b, t_max), stop, dtype=np.int32)
        teacher = np.full((b, t_max), IGNORE_ID, dtype=np.int32)
        step_mask = np.zeros((b, t_max), dtype=bool)
        ended = np.zeros((b,), dtype=bool)

        if not table_mode:
            ep_pano[:, 0] = obs.pano_feat
        t_done = t_max  # first step index NOT recorded by the loop body
        for t in range(t_max):
            if table_mode:
                ep_node[:, t] = offs + obs.node
            ep_view[:, t] = obs.view_index
            ep_cpoint[:, t] = obs.cand_point
            ep_cang[:, t] = obs.cand_ang
            a_t = obs.teacher.copy() if policy is None else policy(t, obs, ended)
            live = ~ended
            step_mask[:, t] = live
            teacher[:, t] = np.where(live, obs.teacher, IGNORE_ID)
            actions[:, t] = np.where(live, a_t, stop)
            # stop/ended slots become no-ops
            env_actions = np.where(live & (a_t != stop), a_t, -1)
            ended |= a_t == stop
            if t + 1 < t_max:
                obs = self.step(
                    env_actions, obs,
                    pano_out=None if table_mode else ep_pano[:, t + 1])
                if ended.all():
                    t_done = t + 1
                    break

        if t_done < t_max:
            # remaining steps are masked out; fill with copies of the
            # final obs to keep fixed shapes (pano at t_done was already
            # written by the last env.step)
            if table_mode:
                ep_node[:, t_done] = offs + obs.node
                ep_node[:, t_done + 1 :] = ep_node[:, t_done : t_done + 1]
            else:
                ep_pano[:, t_done + 1 :] = ep_pano[:, t_done : t_done + 1]
            ep_view[:, t_done] = obs.view_index
            ep_cpoint[:, t_done] = obs.cand_point
            ep_cang[:, t_done] = obs.cand_ang
            ep_view[:, t_done + 1 :] = ep_view[:, t_done : t_done + 1]
            ep_cpoint[:, t_done + 1 :] = ep_cpoint[:, t_done : t_done + 1]
            ep_cang[:, t_done + 1 :] = ep_cang[:, t_done : t_done + 1]

        txt_ids, txt_mask = self.txt_batch()
        return EpisodeBatch(
            txt_ids=txt_ids,
            txt_mask=txt_mask,
            pano_feat=ep_pano,
            view_index=ep_view,
            cand_point=ep_cpoint,
            cand_ang=ep_cang,
            actions=actions,
            step_mask=step_mask,
            teacher=teacher,
            node_idx=ep_node,
        )

    # ------------------------------------------------------------------
    def eval_metrics(self, preds: List[dict]) -> Tuple[Dict[str, float], Dict]:
        """Parity with env.py:359-386. preds: [{instr_id, trajectory}]
        where trajectory is a list of viewpoint ids (or (vp, h, e) tuples)."""
        per_item = []
        details = {}
        for item in preds:
            instr_id = item["instr_id"]
            traj = [x[0] if isinstance(x, (tuple, list)) else x
                    for x in item["trajectory"]]
            scan, gt_path = self.gt_trajs[instr_id]
            g = self.graphs[scan]
            scores = eval_r2r_item(
                g.dist, g.indices(traj), g.indices(gt_path), self.error_margin
            )
            per_item.append(scores)
            details[instr_id] = scores
        return aggregate_metrics(per_item), details
