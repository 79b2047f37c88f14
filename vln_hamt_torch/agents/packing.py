"""Packed imitation-learning episode batches (numpy only), the port of
``vln_hamt_tpu/agents/packing.py:PackedILStream``.

The IL episode forward runs a fixed ``max_action_len`` steps, but R2R
teacher paths average about 5 live steps of 15: two thirds of its
transformer sweeps land on padding. The reference's host loop breaks
early (``agent_cmt.py:308`` and the all-ended break); a fixed-length
episode loop packs instead: several episodes ride one slot back to back,
each cell of the (slots, T) grid tagged with its episode id, local step
and episode-start flag, and the device loop resets the slot's history
cache at start cells (``rollout.py:build_packed_il_forward``). The IL
loss is the same summed CE over exactly the same (episode, step) cells,
normalized by the episode count, so a packed update is
gradient-equivalent to the unpacked updates over the same episodes
(``tests/test_torch_packed_il.py``).

Feature-table transport only: cells carry node rows of the device table;
packing never touches features on the host. REVERIE's stream
(:class:`ReveriePackedILStream`) adds a per-cell object target and draws
its episodes from the agent's teacher loop.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..env.observation import IGNORE_ID

#: env draws a pack may take before it is handed out partly filled
MAX_REFILLS = 8


class PackedILStream:
    """Pulls teacher episodes from the env and packs them densely.

    ``next_pack()`` returns one host-side pack (schema below). Episodes
    are sliced out of the env's teacher ``EpisodeBatch``es and placed
    best-fit (the slot with the most room first) until no queued episode
    fits or ``text_cap`` episodes are placed; leftovers stay queued for
    the next pack, so every drawn episode is trained on exactly once.

    Pack schema (numpy; S = slots, T = max_action_len, E = text_cap):
      txt_ids (E, L) int32 / txt_mask (E, L) bool: one row per packed
        episode (padding rows keep one live token);
      node_idx (S, T) int32: rows of the feature table;
      view_index (S, T), cand_point (S, T, C), cand_ang (S, T, C, A);
      actions / teacher (S, T) int32 (teacher = IGNORE_ID on dead cells,
        so the packed CE sums exactly the live (episode, step) cells);
      live / is_start (S, T) bool, ep_id / local_t (S, T) int32;
      n_episodes () float32: the loss's normalizer;
    plus per cell the subclass's ``extra_step_fields``.
    """

    #: further per-cell (S, T) fields: name -> (fill value, dtype)
    extra_step_fields: Dict[str, tuple] = {}

    def __init__(self, env):
        if env.feat_offsets is None:
            raise ValueError("packed IL needs feature-table transport "
                             "(agent.enable_feature_table)")
        self.env = env
        self.slots = env.batch_size
        self.t_pack = env.max_action_len
        self.spec = env.spec
        # about 4 cells per episode bounds R2R's mean live length from
        # below; more rows only pad the text encoding
        self.text_cap = max(self.slots + 1, (self.slots * self.t_pack) // 4)
        self._queue: List[Dict[str, np.ndarray]] = []
        #: episodes handed out in packs so far
        self.episodes_consumed = 0

    def _draw(self) -> List[Dict[str, np.ndarray]]:
        """One env draw -> per-episode dicts, sliced to their live length."""
        ep = self.env.teacher_episode()
        if ep.node_idx is None:
            raise ValueError("the packed IL env must be in feature-table (node index) mode")
        lens = ep.step_mask.sum(axis=1).astype(np.int64)
        out = []
        for i in range(ep.actions.shape[0]):
            n = int(lens[i])
            if n == 0:  # step 0 is always live; guard
                continue
            out.append(dict(
                txt_ids=np.asarray(ep.txt_ids[i]),
                txt_mask=np.asarray(ep.txt_mask[i]),
                node_idx=np.asarray(ep.node_idx[i, :n]),
                view_index=np.asarray(ep.view_index[i, :n]),
                cand_point=np.asarray(ep.cand_point[i, :n]),
                cand_ang=np.asarray(ep.cand_ang[i, :n]),
                actions=np.asarray(ep.actions[i, :n]),
                teacher=np.asarray(ep.teacher[i, :n]),
            ))
        return out

    def next_pack(self) -> Dict[str, np.ndarray]:
        s, t, spec = self.slots, self.t_pack, self.spec
        c, a = spec.max_candidates, spec.angle_feat_size
        l_txt = self.env.max_instr_len

        pack = dict(
            txt_ids=np.zeros((self.text_cap, l_txt), np.int32),
            txt_mask=np.zeros((self.text_cap, l_txt), bool),
            node_idx=np.zeros((s, t), np.int32),
            view_index=np.zeros((s, t), np.int32),
            cand_point=np.full((s, t, c), -1, np.int32),
            cand_ang=np.zeros((s, t, c, a), np.float32),
            actions=np.full((s, t), spec.stop_slot, np.int32),
            teacher=np.full((s, t), IGNORE_ID, np.int32),
            live=np.zeros((s, t), bool),
            is_start=np.zeros((s, t), bool),
            ep_id=np.zeros((s, t), np.int32),
            local_t=np.zeros((s, t), np.int32),
        )
        for k, (fill, dtype) in self.extra_step_fields.items():
            pack[k] = np.full((s, t), fill, dtype)
        # padding rows keep one live token: an all-masked row would
        # softmax over a uniform -10000 field (finite but meaningless)
        pack["txt_mask"][:, 0] = True

        remaining = np.full((s,), t, np.int64)
        n_placed = 0
        refills = 0
        while n_placed < self.text_cap:
            slot = int(np.argmax(remaining))
            room = int(remaining[slot])
            if room <= 0:
                break
            j = next((k for k, e in enumerate(self._queue)
                      if len(e["actions"]) <= room), None)
            if j is None:
                if refills >= MAX_REFILLS:
                    break
                self._queue.extend(self._draw())
                refills += 1
                continue
            e = self._queue.pop(j)
            n = len(e["actions"])
            t0 = t - room
            sl = np.s_[slot, t0:t0 + n]
            for k in ("node_idx", "view_index", "cand_point", "cand_ang", "actions",
                      "teacher", *self.extra_step_fields):
                pack[k][sl] = e[k]
            pack["live"][sl] = True
            pack["is_start"][slot, t0] = True
            pack["ep_id"][sl] = n_placed
            pack["local_t"][sl] = np.arange(n)
            ids = e["txt_ids"][:l_txt]
            pack["txt_ids"][n_placed, :len(ids)] = ids
            pack["txt_mask"][n_placed] = False
            pack["txt_mask"][n_placed, :len(ids)] = e["txt_mask"][:l_txt]
            remaining[slot] -= n
            n_placed += 1

        if n_placed == 0:
            raise RuntimeError("packing produced an empty pack")
        pack["n_episodes"] = np.float32(n_placed)
        self.episodes_consumed += n_placed
        return pack


class ReveriePackedILStream(PackedILStream):
    """Packed REVERIE teacher episodes (JAX ``packing.py:
    ReveriePackedILStream``): the base packing plus the per-cell
    ``ref_teacher``, the target object's slot among the viewpoint's
    objects (IGNORE_ID elsewhere), so the packed update applies the dual
    act + object CE over exactly the live cells. Episodes come from the
    agent's teacher loop (``ReverieAgent.ref_teacher_rollout``, STOP as
    the object-stop slot) on this stream's own env, which it passes in.
    Object features stay in the device object tables (node-aligned with
    the panorama table)."""

    extra_step_fields = {"ref_teacher": (IGNORE_ID, np.int32)}

    def __init__(self, env, agent):
        super().__init__(env)
        self.agent = agent

    def _draw(self) -> List[Dict[str, np.ndarray]]:
        r = self.agent.ref_teacher_rollout(self.env)
        stack = lambda attr: np.stack([getattr(o, attr) for o in r["obs"]], axis=1)  # noqa: E731
        cells = {"node_idx": np.stack([r["feat_offs"] + o.node for o in r["obs"]],
                                      axis=1).astype(np.int32),
                 "view_index": stack("view_index"), "cand_point": stack("cand_point"),
                 "cand_ang": stack("cand_ang"), "actions": r["actions"],
                 "teacher": r["teacher"], "ref_teacher": r["ref_teacher"]}
        out = []
        for i, n in enumerate(r["step_mask"].sum(axis=1)):
            if n == 0:  # step 0 is always live; guard
                continue
            ep = {k: np.asarray(v[i, :n]) for k, v in cells.items()}
            ep.update(txt_ids=np.asarray(r["txt_ids"][i]), txt_mask=np.asarray(r["txt_mask"][i]))
            out.append(ep)
        return out


def unpack_episodes(pack: Dict[str, np.ndarray], t_max: int,
                    stop_slot: int) -> Dict[str, np.ndarray]:
    """The packed episodes as an unpacked (E, T) teacher batch in the
    episode forward's schema, the packed forward's oracle (as
    ``tests/test_packed_il.py:unpack_to_episode_batch``): each episode's
    live cells from step 0, its tail padded with its last cell, STOP and
    IGNORE_ID (REVERIE's ``ref_teacher`` too; ``stop_slot`` its object
    stop)."""
    n_eps = int(pack["n_episodes"])
    targets = [k for k in ("teacher", "ref_teacher") if k in pack]
    out = {"txt_ids": pack["txt_ids"][:n_eps], "txt_mask": pack["txt_mask"][:n_eps],
           "actions": np.full((n_eps, t_max), stop_slot, np.int32),
           "step_mask": np.zeros((n_eps, t_max), bool),
           **{k: np.full((n_eps, t_max), IGNORE_ID, np.int32) for k in targets}}
    cells = ("node_idx", "view_index", "cand_point", "cand_ang")
    for k in cells:
        out[k] = np.zeros((n_eps, t_max) + pack[k].shape[2:], pack[k].dtype)
    for e in range(n_eps):
        where = np.argwhere((pack["ep_id"] == e) & pack["live"])
        s, ts = int(where[0, 0]), np.sort(where[:, 1])
        n, sl = len(ts), np.s_[ts[0]:ts[0] + len(ts)]
        for k in cells:
            out[k][e, :n] = pack[k][s][sl]
            out[k][e, n:] = out[k][e, n - 1:n]
        for k in ("actions", *targets):
            out[k][e, :n] = pack[k][s][sl]
        out["step_mask"][e, :n] = True
    return out
