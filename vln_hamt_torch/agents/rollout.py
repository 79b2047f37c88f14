"""Device-resident episode computation (torch), the port of
``vln_hamt_tpu/agents/rollout.py``: the device rollout
(:func:`build_device_rollout`), greedy for evaluation or sampled with
the in-loop R2R reward for the ``sample`` update, optionally with
teacher-forced IL lanes in the same loop; and the teacher-forced episode
of IL training and of the A2C replay (:func:`build_episode_forward`).

The reference interleaves per-step GPU forwards with Python list
appends and simulator calls (``agent_cmt.py:248-529``). Here a whole
episode runs on the device: the feature table and the nav tables
(``data/nav_graph.py:build_nav_tables``) live in device memory, so the
graph transition is a gather, the nDTW reward a DP row extension and
the goal distance a cost-slab read, and the Python loop over ``t_max``
only enqueues work — nothing inside it reads a value back to the host.
The sampling rollout keeps its autograd graph, so the ``sample`` update
differentiates through it: no replay, and no key-derivation invariant
to keep (the JAX package's fold_in scheme, rollout.py:39-51).

History cache invariant (as in the JAX package): the cache has a fixed
``T + 1`` slots, the token of step ``t`` is written at slot ``t + 1``,
and per-sample history length is ``1 + (# live steps so far)`` — masked
attention reproduces the reference's per-sample ``hist_lens``
bookkeeping (agent_cmt.py:305-306,399-401) without ragged shapes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch

from ..data.angle import all_point_angle_feature
from ..models.hamt import HAMT, Critic


def hist_mask(hist_len: torch.Tensor, h: int) -> torch.Tensor:
    return torch.arange(h, device=hist_len.device)[None, :] < hist_len[:, None]


def make_expand_obs(views: int, angle_feat_size: int, ob_type: str = "pano",
                    device=None) -> Callable[..., Dict[str, torch.Tensor]]:
    """Device-side expansion of compact observations.

    The (B, V, D) panorama feature matrix + candidate index/angle tables
    (see env/observation.py) are gathered on the device into the fixed
    layout [candidates | STOP | panorama]. Must match
    ``env/observation.py:expand_obs_np`` exactly (tested).
    """
    table = torch.as_tensor(all_point_angle_feature(angle_feat_size),
                            device=device)  # (36, 36, A)
    view_ids = torch.arange(views, device=device)

    def expand_obs(pano_feat, view_index, cand_point, cand_ang):
        lead = tuple(pano_feat.shape[:-2])
        d = pano_feat.shape[-1]
        a = cand_ang.shape[-1]
        c = cand_point.shape[-1]
        dtype = pano_feat.dtype

        valid = cand_point >= 0
        idx = torch.where(valid, cand_point, 0).long()
        cand_feats = torch.gather(pano_feat, -2, idx[..., None].expand(*lead, c, d))
        cand_feats = torch.where(valid[..., None], cand_feats, 0.0)
        stop_img = pano_feat.new_zeros(lead + (1, d))
        ob_img = torch.cat([cand_feats, stop_img, pano_feat], dim=-2)

        pano_ang = table[view_index.long()].to(dtype)  # (..., V, A)
        stop_ang = pano_feat.new_zeros(lead + (1, a))
        ob_ang = torch.cat(
            [torch.where(valid[..., None], cand_ang.to(dtype), 0.0), stop_ang, pano_ang],
            dim=-2)

        ob_nav = torch.cat(
            [valid.to(torch.int32),
             torch.full(lead + (1,), 2, dtype=torch.int32, device=valid.device),
             torch.zeros(lead + (views,), dtype=torch.int32, device=valid.device)],
            dim=-1)

        onehot = (idx[..., None] == view_ids) & valid[..., None]
        claimed = onehot.any(dim=-2)
        if ob_type == "cand":
            pano_region = torch.zeros_like(claimed)
        else:
            pano_region = ~claimed
        ob_mask = torch.cat(
            [valid, torch.ones(lead + (1,), dtype=torch.bool, device=valid.device),
             pano_region], dim=-1)

        hist_img = torch.gather(
            pano_feat, -2, view_index.long()[..., None, None].expand(*lead, 1, d)
        ).squeeze(-2)

        return dict(ob_img=ob_img, ob_ang=ob_ang, ob_nav=ob_nav,
                    ob_mask=ob_mask, hist_img=hist_img,
                    pano_img=pano_feat, pano_ang=pano_ang)

    return expand_obs


def gumbel_max(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One categorical draw per row of ``logits`` (B, N) by the
    Gumbel-max trick, the method of ``jax.random.categorical``:
    ``argmax(logits + g)`` with ``g = -log(-log(u))``. ``u`` is clamped
    into (0, 1), so every ``g`` is finite and a -inf (masked) slot is
    never drawn. Draws from ``generator`` only, and reads nothing back
    to the host (``torch.multinomial`` may)."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=logits.dtype)
    fi = torch.finfo(u.dtype)
    u = u.clamp(fi.tiny, 1.0 - fi.eps / 2)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def make_policy_core(model: HAMT, critic: Critic, expand_obs):
    """One interactive policy step (``_make_policy_core`` of the JAX
    package).

    core(txt_embeds, txt_mask, hist_cache, hist_len, t, pano_feat,
         view_index, cand_point, cand_ang, live, forbid, given_action, mode,
         generator=None)
      -> action (B,), logits (B, N), state (B, D), value (B,), hist_cache,
         hist_len

    Modes: ``argmax`` and ``sample`` (Gumbel-max from ``generator``) over
    the logits with ``forbid`` (B, N) masked; ``teacher`` takes
    ``given_action``; ``mixed`` takes ``given_action`` where it is >= 0
    (teacher-forced lanes) and samples elsewhere.

    ``t`` is a step id on the device: 0-d (lock-step rollout) or (B,)
    (per-sample positions); the new history token goes to slot ``t+1``
    of each sample. The cache is written out of place, as the JAX
    package's ``dynamic_update_slice``: under autograd an op that saved
    the old cache for its backward (a linear layer of ``h_layers``, say)
    would otherwise see it change.
    """

    def core(txt_embeds, txt_mask, hist_cache, hist_len, t,
             pano_feat, view_index, cand_point, cand_ang,
             live, forbid, given_action, mode: str,
             generator: Optional[torch.Generator] = None):
        h_max = hist_cache.shape[1]
        ob = expand_obs(pano_feat, view_index, cand_point, cand_ang)
        logits, state = model.plan(
            txt_embeds, txt_mask, hist_cache, hist_mask(hist_len, h_max),
            ob["ob_img"], ob["ob_ang"], ob["ob_nav"], ob["ob_mask"])
        if mode == "teacher":
            action = given_action
        elif mode in ("argmax", "sample", "mixed"):
            masked = logits.detach().masked_fill(forbid, -math.inf)
            if mode == "argmax":
                action = torch.argmax(masked, dim=-1)
            else:
                if generator is None:
                    raise ValueError(f"policy mode {mode!r} needs a torch.Generator")
                action = gumbel_max(masked, generator)
                if mode == "mixed":
                    action = torch.where(given_action >= 0, given_action, action)
        else:
            raise ValueError(f"policy mode {mode!r}")
        action = action.long()

        value = critic(state)

        act_ang = torch.gather(
            ob["ob_ang"], 1, action[:, None, None].expand(-1, 1, ob["ob_ang"].shape[-1])
        ).squeeze(1)
        new_tok = model.encode_history(ob["hist_img"], act_ang, t,
                                       ob["pano_img"], ob["pano_ang"])
        b = hist_cache.shape[0]
        index = (torch.arange(b, device=hist_cache.device), t.expand(b) + 1)
        hist_cache = hist_cache.index_put(index, new_tok.to(hist_cache.dtype))
        hist_len = hist_len + live.to(hist_len.dtype)
        return action, logits, state, value, hist_cache, hist_len

    return core


def device_angle_feats(heading: torch.Tensor, elevation: torch.Tensor,
                       a_size: int) -> torch.Tensor:
    """torch mirror of data.angle.angle_features (fp32 trig)."""
    heading = heading.float()
    elevation = elevation.float()
    base = torch.stack([torch.sin(heading), torch.cos(heading),
                        torch.sin(elevation), torch.cos(elevation)], dim=-1)
    reps = a_size // 4
    if reps > 1:
        base = base.repeat((1,) * (base.dim() - 1) + (reps,))
    return base


def _dp_extend(dp: torch.Tensor, cost: torch.Tensor) -> torch.Tensor:
    """One DTW row extension, vectorized over the batch.

    dp (B, R+1): previous DP row; cost (B, R): dist(new_node, ref_j).
    Mirrors eval.metrics.IncrementalNDTW._extend:
      cur[j] = cost[j-1] + min(prev[j], prev[j-1], cur[j-1]), cur[0]=inf,
    one reference column after another as the JAX package's scan (R is a
    handful of columns for R2R). Padded columns (inf cost) stay inf.
    """
    cur = torch.full_like(dp[:, 0], math.inf)
    cols = [cur]
    for j in range(cost.shape[1]):
        cur = cost[:, j] + torch.minimum(torch.minimum(dp[:, j + 1], dp[:, j]), cur)
        cols.append(cur)
    return torch.stack(cols, dim=1)


def build_device_rollout(model: HAMT, critic: Critic, t_max: int,
                         ob_type: str = "pano", error_margin: float = 3.0,
                         task: str = "r2r"):
    """The JAX ``build_device_rollout`` for R2R: a whole rollout of a
    batch on the device, greedy (evaluation) or sampled (the ``sample``
    update), with the in-loop R2R reward (``_step_rewards``,
    agent_cmt.py:407-445): nDTW by one DP row extension per step
    (:func:`_dp_extend`) and the goal distance by a cost-slab read.

    Returns rollout(txt_ids, txt_mask, feat_table, nav, start_node,
    start_view, offs=None, task_inputs=None, *, policy="argmax",
    compute_rewards=False, compute_bootstrap=False, il=None,
    generator=None) -> (ep, extras) with the JAX package's keys:

    - ``ep``: batch-major (B, T) records of nodes, views, candidate
      tables, actions and live masks plus the final pose;
    - ``extras``: time-major ``rollout_logits`` (T, B, N), ``values``,
      ``masks``, ``rewards`` (detached; zero without
      ``compute_rewards``) and ``bootstrap_mask``; ``last_value`` (B,)
      with ``compute_bootstrap``, the critic on the final observation
      (RL lanes only, no gradient); ``il_logits`` (T, B_il, N) with
      ``il``.

    ``policy`` is ``argmax`` or ``sample`` (from ``generator``).
    ``compute_rewards`` needs ``offs`` (B,), each item's scan offset in
    the feature table, and ``task_inputs`` with ``ref_cost``
    (B, N_scan_max, R), the distance of each node of the item's scan to
    each reference node (inf-padded), and ``ref_len`` (B,).

    ``il``: teacher-forced lanes run in the same loop (the merged
    ``sample`` update): batch-major (B_il, T) ``node_idx``,
    ``view_index``, ``actions`` and ``step_mask`` of a recorded teacher
    episode, with ``txt_ids`` / ``txt_mask`` the concatenation
    [RL lanes | IL lanes]. IL lanes take their pose from the record,
    force the recorded action and get no reward; the RL lanes sample.

    Gradients flow as the caller's grad mode says: the ``sample`` update
    differentiates through the loop (integer transitions and rewards
    carry none), evaluation calls it under ``torch.no_grad()``. The loop
    over ``t_max`` only enqueues work: nothing is read back to the host.
    """
    if task != "r2r":
        raise NotImplementedError(f"device rollout for task {task!r}: task variants "
                                  "are ROADMAP item A11")
    cfg = model.config
    if t_max > cfg.max_action_steps:
        raise ValueError(f"t_max {t_max} exceeds the history position table "
                         f"({cfg.max_action_steps})")
    device = next(model.parameters()).device
    expand_obs = make_expand_obs(36, cfg.angle_feat_size, ob_type, device=device)
    core = make_policy_core(model, critic, expand_obs)
    steps = torch.arange(t_max, device=device)

    def rollout(txt_ids, txt_mask, feat_table, nav, start_node, start_view,
                offs=None, task_inputs=None, *, policy: str = "argmax",
                compute_rewards: bool = False, compute_bootstrap: bool = False,
                il: Optional[Dict[str, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        if policy not in ("argmax", "sample"):
            raise ValueError(f"rollout policy {policy!r}")
        if il is not None and policy != "sample":
            raise ValueError("teacher-forced il lanes ride a sampling rollout "
                             "(policy='sample')")
        b = start_node.shape[0]
        b_il = 0 if il is None else il["actions"].shape[0]
        bt = b + b_il
        if txt_ids.shape[0] != bt:
            raise ValueError(f"{txt_ids.shape[0]} text rows for {b} RL + {b_il} IL lanes")
        stop = nav["nbr_global"].shape[1]  # slot layout: [C cands | STOP | pano]
        n_ob = stop + 1 + 36

        txt_embeds = model.encode_text(txt_ids, txt_mask)
        hist0 = model.init_history(bt)
        hist_cache = torch.cat([hist0[:, None],
                                hist0.new_zeros((bt, t_max, cfg.hidden_size))], dim=1)
        hist_len = torch.ones(bt, dtype=torch.int32, device=device)

        def cand_tables(node, view):
            cg = nav["nbr_global"][node].long()  # (B, C)
            valid = cg >= 0
            cp = torch.where(valid, nav["nbr_point"][node], -1)
            base_h = (view % 12).float() * (math.pi / 6.0)
            ang = device_angle_feats(nav["nbr_head"][node] - base_h[:, None],
                                     nav["nbr_elev"][node], cfg.angle_feat_size)
            ang = torch.where(valid[:, :, None], ang, 0.0)
            return cg, valid, cp, ang

        node, view = start_node.long(), start_view.long()
        if compute_rewards:
            bi = torch.arange(b, device=device)
            offs = offs.long()
            ref_cost = task_inputs["ref_cost"]
            rl = task_inputs["ref_len"].long()

            def ref_cost_at(node):  # (B, R) dist(node, ref_j)
                return ref_cost[bi, node - offs]

            def ndtw_val(dp):
                return torch.exp(-dp[bi, rl] / (error_margin * rl.float()))

            def goal_dist(node):  # dist to the last reference node
                return ref_cost_at(node)[bi, rl - 1]

            # the nDTW DP row: closed column 0, then the start node
            dp = torch.full((b, ref_cost.shape[2] + 1), math.inf, device=device)
            dp[:, 0] = 0.0
            dp = _dp_extend(dp, ref_cost_at(node))
            last_ndtw, last_dist = ndtw_val(dp), goal_dist(node)

        if il is not None:
            il_node, il_view = il["node_idx"].long(), il["view_index"].long()
            il_act, il_live = il["actions"].long(), il["step_mask"]
            rl_given = torch.full((b,), -1, dtype=torch.long, device=device)
        mode = policy if il is None else "mixed"
        ended = torch.zeros(b, dtype=torch.bool, device=device)
        forbid = torch.zeros((bt, n_ob), dtype=torch.bool, device=device)
        given = torch.zeros(b, dtype=torch.long, device=device)
        ys, il_logits = [], []
        for t in range(t_max):
            live = ~ended
            node_all, view_all, live_all = node, view, live
            if il is not None:
                node_all = torch.cat([node, il_node[:, t]])
                view_all = torch.cat([view, il_view[:, t]])
                live_all = torch.cat([live, il_live[:, t]])
                given = torch.cat([rl_given, il_act[:, t]])
            cg, valid, cand_point, cand_ang = cand_tables(node_all, view_all)
            pano = feat_table[node_all]
            action, logits, _, value, hist_cache, hist_len = core(
                txt_embeds, txt_mask, hist_cache, hist_len, steps[t], pano,
                view_all, cand_point, cand_ang, live_all, forbid, given, mode, generator)
            if il is not None:
                il_logits.append(logits[b:])
                action, logits, value = action[:b], logits[:b], value[:b]
                cg, valid = cg[:b], valid[:b]
                cand_point, cand_ang = cand_point[:b], cand_ang[:b]

            rec_action = torch.where(live, action, stop)
            slot = action.clamp(0, stop - 1)[:, None]
            tgt = torch.gather(cg, 1, slot)[:, 0]
            tgt_ok = torch.gather(valid, 1, slot)[:, 0]
            moved = live & (action < stop) & tgt_ok
            new_node = torch.where(moved, tgt, node)
            new_view = torch.where(moved, torch.gather(cand_point, 1, slot)[:, 0].long(),
                                   view)
            stopped = action == stop
            if compute_rewards:
                # the prediction path grows on every live move
                extend = live & ~stopped
                dp = torch.where(extend[:, None], _dp_extend(dp, ref_cost_at(new_node)), dp)
                cur_ndtw = ndtw_val(dp)
                nr = cur_ndtw - last_ndtw
                dist = goal_dist(new_node)
                delta = -(dist - last_dist)
                stop_r = torch.where(dist < error_margin, 2.0 + cur_ndtw * 2.0, -2.0)
                move_r = torch.where(delta > 0.0, 1.0 + nr, -1.0 + nr)
                miss = (last_dist <= 1.0) & (dist - last_dist > 0.0)
                move_r = move_r - torch.where(miss, (1.0 - last_dist) * 2.0, 0.0)
                reward = torch.where(live, torch.where(stopped, stop_r, move_r), 0.0)
                last_ndtw, last_dist = cur_ndtw, dist
            else:
                reward = torch.zeros(b, device=device)
            ys.append((rec_action, logits, value, reward, live, node, view, cand_point,
                       cand_ang))
            ended = ended | stopped
            node, view = new_node, new_view

        actions, logits, values, rewards, lives, nodes, views, cpoints, cangs = (
            torch.stack(x) for x in zip(*ys))
        _, _, final_cp, final_ca = cand_tables(node, view)
        i32 = torch.int32
        ep = {
            "txt_ids": txt_ids, "txt_mask": txt_mask,
            "node_idx": nodes.T.to(i32),
            "view_index": views.T.to(i32),
            "cand_point": cpoints.transpose(0, 1).to(i32),
            "cand_ang": cangs.transpose(0, 1),
            "actions": actions.T.to(i32),
            "step_mask": lives.T,
            "final_node_idx": node.to(i32),
            "final_view_index": view.to(i32),
            "final_cand_point": final_cp.to(i32),
            "final_cand_ang": final_ca,
        }
        extras = {
            "rewards": rewards.detach(),  # (T, B)
            "masks": lives.float(),       # (T, B)
            "bootstrap_mask": ~ended,     # (B,)
            "rollout_logits": logits,     # (T, B, N)
            "values": values,             # (T, B)
        }
        if il is not None:
            extras["il_logits"] = torch.stack(il_logits)  # (T, B_il, N)
        if compute_bootstrap:
            # the critic on the final observation (agent_cmt.py:481-484),
            # RL lanes only; under no_lang_ca the text states are
            # (X+1, B, L, D), batch on axis 1
            with torch.no_grad():
                fob = expand_obs(feat_table[node], view, final_cp, final_ca)
                txt_f = txt_embeds[:, :b] if txt_embeds.dim() == 4 else txt_embeds[:b]
                _, last_state = model.plan(
                    txt_f, txt_mask[:b], hist_cache[:b],
                    hist_mask(hist_len[:b], hist_cache.shape[1]),
                    fob["ob_img"], fob["ob_ang"], fob["ob_nav"], fob["ob_mask"])
                extras["last_value"] = critic(last_state)
        return ep, extras

    return rollout


@dataclasses.dataclass
class EpisodeOutputs:
    logits: torch.Tensor  # (T, B, N) float32
    states: torch.Tensor  # (T, B, D)
    values: torch.Tensor  # (T, B)
    last_value: torch.Tensor  # (B,) bootstrap value of the final obs
    hist_cache: torch.Tensor  # (B, T+1, D) final history cache


def build_episode_forward(model: HAMT, critic: Critic, ob_type: str = "pano"
                          ) -> Callable[..., EpisodeOutputs]:
    """The teacher-forced episode of ``vln_hamt_tpu/agents/rollout.py:
    build_episode_forward`` (:147-262): the whole recorded episode through
    the model, differentiable end to end.

    Returns episode_forward(ep, feat_table=None) -> EpisodeOutputs, where
    ``ep`` holds device tensors in the compact observation schema:
    txt_ids (B, L), txt_mask (B, L), view_index (B, T), cand_point
    (B, T, C), cand_ang (B, T, C, A), actions (B, T) (the slots taken;
    STOP once ended), step_mask (B, T), and either pano_feat
    (B, T, V, D) or node_idx (B, T) rows of ``feat_table`` (N, V, D).
    Optional final_{pano_feat | node_idx}, final_view_index,
    final_cand_point and final_cand_ang give the observation after the
    last action, for the bootstrap value (no gradient); without them
    ``last_value`` is zero. Dropout follows the modules' train/eval
    mode. The loop over T only enqueues work: nothing is read back.
    """
    cfg = model.config
    device = next(model.parameters()).device
    expand_obs = make_expand_obs(36, cfg.angle_feat_size, ob_type, device=device)
    core = make_policy_core(model, critic, expand_obs)

    def episode_forward(ep: Dict[str, torch.Tensor],
                        feat_table: Optional[torch.Tensor] = None) -> EpisodeOutputs:
        if "node_idx" in ep:
            pano_feat = feat_table[ep["node_idx"].long()]  # one gather, (B, T, V, D)
            final_pano = (feat_table[ep["final_node_idx"].long()]
                          if "final_node_idx" in ep else None)
        else:
            pano_feat, final_pano = ep["pano_feat"], ep.get("final_pano_feat")
        txt_mask = ep["txt_mask"]
        b, t_steps = ep["actions"].shape
        if t_steps > cfg.max_action_steps:
            raise ValueError(f"episode of {t_steps} steps exceeds the history position "
                             f"table ({cfg.max_action_steps})")
        h_max = t_steps + 1

        txt_embeds = model.encode_text(ep["txt_ids"], txt_mask)
        hist0 = model.init_history(b)
        hist_cache = torch.cat([hist0[:, None], hist0.new_zeros((b, t_steps, cfg.hidden_size))],
                               dim=1)
        hist_len = torch.ones(b, dtype=torch.int32, device=device)
        steps = torch.arange(t_steps, device=device)
        logits, states, values = [], [], []
        for t in range(t_steps):
            _, lg, state, value, hist_cache, hist_len = core(
                txt_embeds, txt_mask, hist_cache, hist_len, steps[t], pano_feat[:, t],
                ep["view_index"][:, t], ep["cand_point"][:, t], ep["cand_ang"][:, t],
                ep["step_mask"][:, t], None, ep["actions"][:, t], "teacher")
            logits.append(lg)
            states.append(state)
            values.append(value)

        if final_pano is not None:
            with torch.no_grad():
                ob = expand_obs(final_pano, ep["final_view_index"], ep["final_cand_point"],
                                ep["final_cand_ang"])
                _, last_state = model.plan(
                    txt_embeds, txt_mask, hist_cache, hist_mask(hist_len, h_max),
                    ob["ob_img"], ob["ob_ang"], ob["ob_nav"], ob["ob_mask"])
                last_value = critic(last_state)
        else:
            last_value = torch.zeros(b, device=device)
        return EpisodeOutputs(logits=torch.stack(logits), states=torch.stack(states),
                              values=torch.stack(values), last_value=last_value,
                              hist_cache=hist_cache)

    return episode_forward
