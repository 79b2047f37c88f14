"""REVERIE agent (torch): navigation with object grounding, the port of
``vln_hamt_tpu/agents/reverie.py``.

Parity target: ``NavRefCMTAgent`` (finetune_src/reverie/agent.py) with
the NavRefCMT model (reverie/vlnbert_navref.py, ``HAMT.plan_ref``). The
action space is the observation layout plus one appended slot whose
logit is the largest object logit: choosing it stops the episode and
grounds the predicted object (reverie/agent.py:251-254, 298-304). The
supervision is a dual CE: the action slots (STOP as the appended slot)
and the target object among the final viewpoint's objects
(agent.py:271-275).

Deviation, as in the JAX package: the reference leaves the layout's own
STOP token selectable, though its candidate lookup would fail if it were
ever chosen (agent.py:299-301); it is masked to -inf here, so the
appended object-stop slot is the only stop action
(``rollout.py:full_logits``).

The base agent does the work under ``object_grounding``: its builders
plan with ``plan_ref``, every path reads the node-aligned object tables
(:meth:`ReverieAgent.enable_feature_table`) or the objects the env
observed, and the IL losses add the object CE. This class supplies the
REVERIE rules through the base class's hooks: the teacher's targets
(:meth:`ReverieAgent.ref_teacher_targets`, from its own host loop
:meth:`ReverieAgent.ref_teacher_rollout`), the env's moves (candidate
slots only), the reward (R2R's with the object stop as STOP, over the
distance to the nearest viewpoint that sees the target), the grounded
object at the stop on every evaluator, and the cost slab of the device
rollout's ``reverie`` branch.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..configs import HAMTConfig
from ..data.feature_db import build_object_table
from ..env.observation import IGNORE_ID, ObsBatch
from .agent import HAMTAgent
from .packing import ReveriePackedILStream


class ReverieAgent(HAMTAgent):
    """Navigation and object grounding over ``env/task_envs.py:ReverieNavEnv``."""

    device_rollout_task = "reverie"
    object_grounding = True

    def __init__(self, cfg: HAMTConfig, env=None, seed: int = 0, device=None):
        if cfg.model.obj_feat_size <= 0:
            raise ValueError("REVERIE needs a model with object features (obj_feat_size > 0)")
        super().__init__(cfg, env, seed=seed, device=device)

    def enable_feature_table(self, env=None) -> None:
        """The panorama and nav tables, and the node-aligned object tables
        (features in the compute dtype, view indexes, bbox positions and
        validity; ``data/feature_db.py:build_object_table``), so episodes
        and policy steps ship node rows only."""
        super().enable_feature_table(env)
        env = env or self.env
        tables, offsets = build_object_table(env.graphs, env.obj_db, env.max_objects,
                                             env.obj_feat_size, env._obj_local_pos)
        if offsets != env.feat_offsets:
            raise AssertionError("object and feature tables disagree on scan offsets")
        self._obj_tables = {k: torch.as_tensor(v).to(self.device) for k, v in tables.items()}
        self._obj_tables["fts"] = self._obj_tables["fts"].to(self._feat_dtype)

    def enable_packed_il(self) -> None:
        """Packed IL with the dual CE over REVERIE's packed stream
        (``agents/packing.py:ReveriePackedILStream``)."""
        if self._obj_tables is None:
            raise ValueError("REVERIE packed IL needs the object tables (enable_feature_table)")
        super().enable_packed_il()

    def _make_packer(self, env) -> ReveriePackedILStream:
        return ReveriePackedILStream(env, self)

    # ------------------------------------------------- teacher targets
    def ref_teacher_targets(self, env, obs: ObsBatch) -> Tuple[np.ndarray, np.ndarray]:
        """(teacher action with the object stop, target object slot) of a
        step of ``env`` (reverie/agent.py ``_teacher_action``): STOP maps
        to the appended slot; the object target is the slot of the item's
        ``objId`` among the viewpoint's objects, IGNORE_ID where it is not
        there. ``env`` is passed in, not read from the agent: the packed
        stream steps an env of its own."""
        teacher = np.where(obs.teacher == self.stop_slot, self.stop_action, obs.teacher)
        ref = np.full((obs.batch_size,), IGNORE_ID, np.int32)
        for i, item in enumerate(env.batch):
            want = str(item["objId"])
            for k, oid in enumerate(obs.obj_ids[i]):
                if str(oid) == want:
                    ref[i] = k
                    break
        return teacher.astype(np.int32), ref

    def ref_teacher_rollout(self, env) -> Dict[str, Any]:
        """The teacher-forced episode of ``env``'s next batch on the host
        (JAX ``_ref_teacher_episode``, reverie.py:896-936): per step the
        dual targets, the env stepped along the teacher's candidate
        moves. Returns the observations (padded to ``t_max`` with the
        last), (B, T) actions, teacher, ref_teacher and step_mask, the
        text and the scans' table offsets (None without the table)."""
        obs = env.reset()
        feat_offs = (np.array([env.feat_offsets[it["scan"]] for it in env.batch], np.int64)
                     if env.feat_offsets is not None else None)
        b, t_max = obs.batch_size, env.max_action_len
        stop = self.stop_action
        obs_list = []
        actions = np.full((b, t_max), stop, np.int32)
        teacher = np.full((b, t_max), IGNORE_ID, np.int32)
        ref_teacher = np.full((b, t_max), IGNORE_ID, np.int32)
        step_mask = np.zeros((b, t_max), bool)
        ended = np.zeros((b,), bool)
        for t in range(t_max):
            obs_list.append(obs)
            teacher_t, ref_t = self.ref_teacher_targets(env, obs)
            live = ~ended
            step_mask[:, t] = live
            teacher[:, t] = np.where(live, teacher_t, IGNORE_ID)
            ref_teacher[:, t] = np.where(live, ref_t, IGNORE_ID)
            actions[:, t] = np.where(live, teacher_t, stop)
            env_actions = np.where(live & (teacher_t < self.stop_slot), teacher_t, -1)
            ended = ended | (teacher_t == stop)
            if t + 1 < t_max:
                obs = env.step(env_actions, obs)
                if ended.all():
                    break
        obs_list += [obs_list[-1]] * (t_max - len(obs_list))
        txt_ids, txt_mask = env.txt_batch()
        return {"obs": obs_list, "actions": actions, "teacher": teacher,
                "ref_teacher": ref_teacher, "step_mask": step_mask, "txt_ids": txt_ids,
                "txt_mask": txt_mask, "feat_offs": feat_offs}

    def _teacher_episode(self) -> Dict[str, torch.Tensor]:
        r = self.ref_teacher_rollout(self.env)
        return self._stack_obs_episode(
            r["obs"], r["txt_ids"], r["txt_mask"], r["actions"], r["step_mask"],
            feat_offs=r["feat_offs"],
            targets={"teacher": r["teacher"], "ref_teacher": r["ref_teacher"]})

    # ----------------------------------------------------- host hooks
    def _teacher_actions(self, env, obs: ObsBatch) -> np.ndarray:
        teacher = self.ref_teacher_targets(env, obs)[0]
        return np.where(teacher >= 0, teacher, self.stop_action)

    def _env_actions(self, a_t: np.ndarray, active: np.ndarray) -> np.ndarray:
        """Candidate moves only (reverie/agent.py:285-287)."""
        return np.where(active & (a_t < self.stop_slot), a_t, -1)

    def _step_rewards(self, t, a_t, live, ended, obs, ep_state) -> np.ndarray:
        """R2R's reward with the object stop as STOP, over the env's
        distance to the nearest viewpoint that sees the target."""
        a_eff = np.where(a_t >= self.num_ob_tokens, self.stop_slot, a_t)
        return super()._step_rewards(t, a_eff, live, ended, obs, ep_state)

    def _update_ended(self, ended, a_t, ep_state, train_rl: bool) -> np.ndarray:
        return ended | (a_t >= self.num_ob_tokens)

    def _pre_env_step(self, t, a_t, live, ended, obs, ep_state, traj) -> None:
        """The grounded object at the (forced) stop (reverie/agent.py:
        298-304): the best of the viewpoint's objects, read back only at a
        step where some episode stops."""
        last = t == self.env.max_action_len - 1
        todo = [i for i in range(len(a_t)) if live[i] and "predObjId" not in traj[i]
                and (a_t[i] >= self.num_ob_tokens or last)]
        if todo:
            obj = self._fetch(ep_state["obj_logits"].float())
            for i in todo:
                traj[i]["predObjId"] = self._grounded(obs.obj_ids[i], obj[i])

    @staticmethod
    def _grounded(ids, obj_logits_i) -> str:
        if not ids:
            return str(None)
        return str(ids[int(np.argmax(obj_logits_i[: len(ids)]))])

    # ------------------------------------------- packed-eval hooks
    def _packed_slot_done(self, st, g, i, a_t_i, steps) -> bool:
        done = a_t_i >= self.num_ob_tokens or steps >= g.env.max_action_len
        if done and "predObjId" not in st:
            st["predObjId"] = self._grounded(g.obs.obj_ids[i], g.aux_np()[i])
        return done

    def _packed_slot_result(self, st, pred: dict) -> None:
        pred["predObjId"] = st.get("predObjId", str(None))

    # ------------------------------------------------- device rollout
    def _device_rollout_inputs(self, env, obs) -> Dict[str, np.ndarray]:
        """The nDTW slabs and the distance to the nearest viewpoint that
        sees the target object (reverie/env.py:206-214), 0 where none
        does, as ``ReverieNavEnv._observe`` has it."""
        ins = super()._device_rollout_inputs(env, obs)
        ins["goal_cost"] = self._goal_cost_slab(env, lambda g, it: [
            g.index(v) for v in env._goal_viewpoints(it["scan"], it["objId"])])
        return ins

    def _fetch_decode_extras(self, extras) -> Dict[str, np.ndarray]:
        return {"obj_pred": self._fetch(extras["obj_pred"]).T}  # (B, T)

    def _decode_device_extras(self, pred, env, i, node, actions, mask, extras_np) -> None:
        """The grounded object at the stop step (the first live object
        stop, else the last step), through the viewpoint's object ids."""
        t_max = actions.shape[1]
        stop_t = next((t for t in range(t_max)
                       if mask[i, t] and actions[i, t] >= self.num_ob_tokens), t_max - 1)
        item = env.batch[i]
        g = env.graphs[item["scan"]]
        entry = env.obj_db.get((item["scan"],
                                g.node_ids[int(node[i, stop_t]) - env.feat_offsets[item["scan"]]]))
        ids = list(entry["obj_ids"][: env.max_objects]) if entry is not None else []
        idx = int(extras_np["obj_pred"][i, stop_t])
        pred["predObjId"] = str(ids[idx]) if idx < len(ids) else str(None)
