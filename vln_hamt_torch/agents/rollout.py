"""Device-resident episode computation (torch), the port of
``vln_hamt_tpu/agents/rollout.py``: the greedy rollout of evaluation
(:func:`build_device_rollout`) and the teacher-forced episode of IL
training (:func:`build_episode_forward`).

The reference interleaves per-step GPU forwards with Python list
appends and simulator calls (``agent_cmt.py:248-529``). Here a whole
greedy episode runs on the device: the feature table and the nav tables
(``data/nav_graph.py:build_nav_tables``) live in device memory, so the
graph transition is a gather, and the Python loop over ``t_max`` only
enqueues work — nothing inside it reads a value back to the host.

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


def make_policy_core(model: HAMT, critic: Critic, expand_obs):
    """One interactive policy step (``_make_policy_core`` of the JAX
    package), modes ``argmax`` and ``teacher``.

    core(txt_embeds, txt_mask, hist_cache, hist_len, t, pano_feat,
         view_index, cand_point, cand_ang, live, forbid, given_action, mode)
      -> action (B,), logits (B, N), state (B, D), value (B,), hist_cache,
         hist_len

    ``t`` is a step id on the device: 0-d (lock-step rollout) or (B,)
    (per-sample positions); the new history token goes to slot ``t+1``
    of each sample. ``forbid`` (B, N) masks actions of ``argmax`` mode.
    The cache is written out of place, as the JAX package's
    ``dynamic_update_slice``: under autograd an op that saved the old
    cache for its backward (a linear layer of ``h_layers``, say) would
    otherwise see it change.
    """

    def core(txt_embeds, txt_mask, hist_cache, hist_len, t,
             pano_feat, view_index, cand_point, cand_ang,
             live, forbid, given_action, mode: str):
        h_max = hist_cache.shape[1]
        ob = expand_obs(pano_feat, view_index, cand_point, cand_ang)
        logits, state = model.plan(
            txt_embeds, txt_mask, hist_cache, hist_mask(hist_len, h_max),
            ob["ob_img"], ob["ob_ang"], ob["ob_nav"], ob["ob_mask"])
        if mode == "argmax":
            action = torch.argmax(logits.masked_fill(forbid, -math.inf), dim=-1)
        elif mode == "teacher":
            action = given_action
        else:
            raise ValueError(f"policy mode {mode!r} (sampling is ROADMAP item A5)")
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


def build_device_rollout(model: HAMT, critic: Critic, t_max: int,
                         ob_type: str = "pano"):
    """The greedy branch of the JAX ``build_device_rollout``: the whole
    argmax rollout of a batch on the device (``policy="argmax"``,
    ``compute_rewards=False``, ``task="r2r"``).

    Returns rollout(txt_ids, txt_mask, feat_table, nav, start_node,
    start_view) -> (ep, extras) with the JAX package's keys:
    ``ep`` batch-major (B, T) records of nodes, views, candidate tables,
    actions and live masks plus the final pose; ``extras`` time-major
    ``rollout_logits`` (T, B, N), ``values``, ``masks``, zero
    ``rewards`` and ``bootstrap_mask``.
    """
    cfg = model.config
    if t_max > cfg.max_action_steps:
        raise ValueError(f"t_max {t_max} exceeds the history position table "
                         f"({cfg.max_action_steps})")
    device = next(model.parameters()).device
    expand_obs = make_expand_obs(36, cfg.angle_feat_size, ob_type, device=device)
    core = make_policy_core(model, critic, expand_obs)
    steps = torch.arange(t_max, device=device)

    @torch.no_grad()
    def rollout(txt_ids, txt_mask, feat_table, nav, start_node, start_view
                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        b = start_node.shape[0]
        stop = nav["nbr_global"].shape[1]  # slot layout: [C cands | STOP | pano]
        n_ob = stop + 1 + 36

        txt_embeds = model.encode_text(txt_ids, txt_mask)
        hist0 = model.init_history(b)
        hist_cache = hist0.new_zeros((b, t_max + 1, cfg.hidden_size))
        hist_cache[:, 0] = hist0
        hist_len = torch.ones(b, dtype=torch.int32, device=device)

        def cand_tables(node, view):
            cg = nav["nbr_global"][node].long()  # (B, C)
            valid = cg >= 0
            cp = torch.where(valid, nav["nbr_point"][node], -1)
            base_h = (view % 12).float() * (math.pi / 6.0)
            ang = device_angle_feats(nav["nbr_head"][node] - base_h[:, None],
                                     nav["nbr_elev"][node], cfg.angle_feat_size)
            ang = torch.where(valid[:, :, None], ang, 0.0)
            return cg, valid, cp, ang

        ended = torch.zeros(b, dtype=torch.bool, device=device)
        node, view = start_node.long(), start_view.long()
        forbid = torch.zeros((b, n_ob), dtype=torch.bool, device=device)
        given = torch.zeros(b, dtype=torch.long, device=device)
        ys = []
        for t in range(t_max):
            live = ~ended
            cg, valid, cand_point, cand_ang = cand_tables(node, view)
            pano = feat_table[node]
            action, logits, _, value, hist_cache, hist_len = core(
                txt_embeds, txt_mask, hist_cache, hist_len, steps[t], pano,
                view, cand_point, cand_ang, live, forbid, given, "argmax")

            rec_action = torch.where(live, action, stop)
            slot = action.clamp(0, stop - 1)[:, None]
            tgt = torch.gather(cg, 1, slot)[:, 0]
            tgt_ok = torch.gather(valid, 1, slot)[:, 0]
            moved = live & (action < stop) & tgt_ok
            new_node = torch.where(moved, tgt, node)
            new_view = torch.where(moved, torch.gather(cand_point, 1, slot)[:, 0].long(),
                                   view)
            ys.append((rec_action, logits, value, live, node, view, cand_point, cand_ang))
            ended = ended | (action == stop)
            node, view = new_node, new_view

        actions, logits, values, lives, nodes, views, cpoints, cangs = (
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
            "rewards": torch.zeros((t_max, b), device=device),  # (T, B)
            "masks": lives.float(),                               # (T, B)
            "bootstrap_mask": ~ended,                             # (B,)
            "rollout_logits": logits,                             # (T, B, N)
            "values": values,                                     # (T, B)
        }
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
