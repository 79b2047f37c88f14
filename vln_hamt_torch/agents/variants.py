"""Task-variant agents (torch): R2R-Back and CVDN, the port of
``vln_hamt_tpu/agents/variants.py``.

Both ride the base agent's machinery; only the reward shaping and the
episode's end differ, through the base class's hooks (the host loop's and
the packed evaluator's) and ``device_rollout_task`` (the device
rollout's branch of the same rules, tested against the hooks).

Parity targets:
- ``Seq2SeqBackAgent`` (finetune_src/r2r/agent_r2rback.py): two-phase
  episodes. The first STOP marks the midstop and the episode goes on back
  toward the start; the reward's distance switches goal at the midstop;
  a failed midstop (>= the error margin) ends the episode in RL.
- ``NavCMTAgent`` (finetune_src/cvdn/agent.py:173-203): a reward without
  nDTW shaping, +2 for a stop only on an end pano, no miss-the-target
  penalty, and zero for a move that keeps the distance.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from .agent import HAMTAgent


class R2RBackAgent(HAMTAgent):
    device_rollout_task = "r2r_back"

    def _device_rollout_inputs(self, env, obs) -> Dict[str, np.ndarray]:
        ins = super()._device_rollout_inputs(env, obs)
        ins["mid_cost"] = self._goal_cost_slab(env, lambda g, it: [g.index(it["midstop"])])
        ins["goal_cost"] = self._goal_cost_slab(env, lambda g, it: [g.index(it["path"][-1])])
        return ins

    def _episode_state_init(self, obs, graphs, traj) -> Dict[str, Any]:
        st = super()._episode_state_init(obs, graphs, traj)
        if obs.dist_to_mid is None:
            raise ValueError("R2RBackAgent needs an R2RBackNavEnv (dist_to_mid)")
        b = obs.batch_size
        st["first_ended"] = np.zeros((b,), bool)
        st["force_ended"] = np.zeros((b,), bool)
        # the first phase's goal is the midstop (agent_r2rback.py:234-237)
        st["last_dist"] = obs.dist_to_mid.copy()
        return st

    def _pre_env_step(self, t, a_t, live, ended, obs, ep_state, traj) -> None:
        """The first STOP records the midstop (agent_r2rback.py:194-198)."""
        for i in range(len(a_t)):
            if live[i] and a_t[i] == self.stop_slot and not ep_state["first_ended"][i]:
                traj[i]["midstop"] = self.env.sim.graph(i).node_ids[int(obs.node[i])]

    def _step_rewards(self, t, a_t, live, ended, obs, ep_state) -> np.ndarray:
        b = len(a_t)
        stop = self.stop_slot
        rewards = np.zeros((b,), np.float32)
        ndtw = ep_state["ndtw"]
        # the phase before this step's update of first_ended
        dist = np.where(ep_state["first_ended"], obs.dist_to_goal,
                        obs.dist_to_mid).astype(np.float32)
        cur_ndtw = np.array([ndtw.value(i) for i in range(b)], np.float32)
        last_dist, last_ndtw = ep_state["last_dist"], ep_state["last_ndtw"]
        for i in range(b):
            if not live[i]:
                continue
            if a_t[i] == stop:
                if dist[i] < 3.0:
                    rewards[i] = 2.0 + cur_ndtw[i] * 2.0
                else:
                    rewards[i] = -2.0
                    # a failed (mid)stop ends the episode in RL
                    # (agent_r2rback.py:254-256)
                    ep_state["force_ended"][i] = True
            else:
                delta = -(dist[i] - last_dist[i])
                nr = cur_ndtw[i] - last_ndtw[i]
                rewards[i] = (1.0 + nr) if delta > 0.0 else (-1.0 + nr)
                if last_dist[i] <= 1.0 and dist[i] - last_dist[i] > 0.0:
                    rewards[i] -= (1.0 - last_dist[i]) * 2.0
        # after the midstop the tracked distance is the final goal's
        # (agent_r2rback.py:270-273)
        new_last = dist.copy()
        for i in range(b):
            if live[i] and a_t[i] == stop and not ep_state["first_ended"][i]:
                new_last[i] = obs.dist_to_goal[i]
        ep_state["last_dist"] = new_last
        ep_state["last_ndtw"] = cur_ndtw
        return rewards

    def _update_ended(self, ended, a_t, ep_state, train_rl: bool) -> np.ndarray:
        """agent_r2rback.py:275-277: the second STOP ends the episode, the
        first only sets first_ended (and in RL a failed midstop ends it)."""
        stopped = a_t == self.stop_slot
        new_ended = ended | (ep_state["first_ended"] & stopped)
        if train_rl:
            new_ended = new_ended | ep_state["force_ended"]
        ep_state["first_ended"] = ep_state["first_ended"] | stopped
        return new_ended

    # the packed evaluator's per-slot phase
    def _packed_slot_init(self, env, i) -> Dict[str, Any]:
        return {"midstop": None}

    def _packed_slot_done(self, st, g, i, a_t_i, steps) -> bool:
        """Two-phase end (agent_r2rback.py:194-198,275-277): the first STOP
        records the midstop and the episode goes on; the second STOP (or
        the step budget) ends it."""
        env = g.env
        if a_t_i == self.stop_slot and st["midstop"] is None:
            st["midstop"] = env.sim.graph(i).node_ids[int(env.sim.node[i])]
            return steps >= env.max_action_len
        return a_t_i == self.stop_slot or steps >= env.max_action_len

    def _packed_slot_result(self, st, pred: dict) -> None:
        pred["midstop"] = st["midstop"]

    def _decode_device_extras(self, pred, env, i, node, actions, mask, extras_np) -> None:
        """The device rollout's midstop: the node of the first live STOP
        (agent_r2rback.py:194-198); None if the episode never stopped,
        as the packed evaluator's slot result."""
        pred["midstop"] = None
        for t in range(actions.shape[1]):
            if mask[i, t] and actions[i, t] == self.stop_slot:
                item = env.batch[i]
                off = env.feat_offsets[item["scan"]]
                pred["midstop"] = env.graphs[item["scan"]].node_ids[int(node[i, t]) - off]
                return


class CVDNAgent(HAMTAgent):
    device_rollout_task = "cvdn"

    def _device_rollout_inputs(self, env, obs) -> Dict[str, np.ndarray]:
        """The distance to the nearest end pano per node (cvdn/env.py:
        80-87); an item without end panos is always at its goal, as
        ``CVDNNavEnv._observe`` has it."""
        return {"goal_cost": self._goal_cost_slab(
            env, lambda g, it: [g.index(v) for v in it.get("end_panos", [])])}

    def _episode_state_init(self, obs, graphs, traj) -> Dict[str, Any]:
        return {"last_dist": obs.dist_to_goal.copy()}

    def _step_rewards(self, t, a_t, live, ended, obs, ep_state) -> np.ndarray:
        b = len(a_t)
        rewards = np.zeros((b,), np.float32)
        dist = obs.dist_to_goal
        last_dist = ep_state["last_dist"]
        for i in range(b):
            if not live[i]:
                continue
            if a_t[i] == self.stop_slot:
                rewards[i] = 2.0 if dist[i] == 0.0 else -2.0
            else:
                delta = -(dist[i] - last_dist[i])
                rewards[i] = 1.0 if delta > 0 else (-1.0 if delta < 0 else 0.0)
        ep_state["last_dist"] = dist.copy()
        return rewards
