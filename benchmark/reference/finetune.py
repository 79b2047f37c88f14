"""The merged IL + A2C update of HAMT's ``--feedback sample``, replayed.

Upstream's training iteration (``agent_cmt.py:248-529, 569-602``): a
teacher-forced episode whose cross-entropy is weighted by ``ml_weight``,
and a sampled episode trained by A2C with R2R's shaped reward, the
critic's bootstrap on the final observation where an episode is still
running, discounted returns, an entropy bonus and the loss divided by the
live steps; the gradient clipped to a global norm of ``grad_clip``, then
AdamW. The port runs both episodes as the lanes of one rollout, sampled
lanes first; this file runs them the same way, drawing the dropout masks,
the attention seeds and the Gumbel noise in the program's order from the
seeds the agent is given (:class:`.hamt.Streams`).

The replay follows the actions the program sampled: the sampled lanes'
actions are the program's output, which the reference judges (each one's
Gumbel-perturbed logit against the best) and does not draw again. Every
other quantity is worked out again from the world and the seeds: the
items behind each lane (matched by their instructions), the start poses,
the teacher's actions, every transition, the rewards, the losses, the
gradients and the optimizer's steps.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from .hamt import HAMT, Params, Streams
from .navigation import (IGNORE, Tables, dp_extend, items_of, record_mismatch, start_view,
                         teacher_episode)

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def _masked_log_softmax(logits: torch.Tensor) -> torch.Tensor:
    finite = torch.isfinite(logits)
    mx = torch.where(finite, logits, -math.inf).amax(-1, keepdim=True).detach()
    z = logits - mx
    lse = torch.log(torch.where(torch.isfinite(z), torch.exp(z), 0.0).sum(-1, keepdim=True))
    return z - lse


class Adam:
    """optax's adam(w) with weight decay 0: bias-corrected moments in
    float32, ``mu_hat / (sqrt(nu_hat) + eps)`` times the learning rate."""

    def __init__(self, params: Params, lr: float):
        self.params, self.lr, self.count = params, lr, 0
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        self.count += 1
        c1 = float(np.float32(1) - np.power(np.float32(ADAM_B1), np.float32(self.count)))
        c2 = float(np.float32(1) - np.power(np.float32(ADAM_B2), np.float32(self.count)))
        for k, g in grads.items():
            mu, nu = self.mu[k], self.nu[k]
            mu.mul_(ADAM_B1).add_(g, alpha=1 - ADAM_B1)
            nu.mul_(ADAM_B2).addcmul_(g, g, value=1 - ADAM_B2)
            upd = (mu / c1) / ((nu / c2).sqrt() + ADAM_EPS)
            self.params[k].sub_(self.lr * upd)


class Replay:
    """Replays a sequence of merged updates from the initial weights."""

    def __init__(self, cfg: dict, tables: Tables, feats: torch.Tensor, by_text: Dict[tuple, dict],
                 weights: Params, critic_weights: Params, agent_seed: int, device):
        self.m, self.env, self.train = cfg["model"], cfg["env"], cfg["train"]
        self.tables, self.feats, self.by_text, self.device = tables, feats, by_text, device
        self.w = {k: v.detach().requires_grad_() for k, v in weights.items()}
        self.cw = {k: v.detach().requires_grad_() for k, v in critic_weights.items()}
        self.opt = Adam(self.w, self.train["lr"])
        self.copt = Adam(self.cw, self.train["lr"])
        self.streams = Streams(device, agent_seed)
        self.model = HAMT(self.m, self.w, self.cw, training=True, streams=self.streams)

    def update(self, rec: dict) -> dict:
        """One update over the program's record ``rec`` (the sampled
        lanes' ``txt_ids``, ``txt_mask``, ``start_node``, ``actions``,
        ``node_idx``, ``view_index``, ``step_mask``; the teacher lanes'
        ``il_txt_ids``, ``il_txt_mask``, ``il_node_idx``, ``il_view_index``,
        ``il_actions``, ``il_step_mask``). Returns the loss, the clipped
        gradients, the perturbed logits of the sampled lanes and the
        count of the record's entries that disagree with the world
        (:func:`.navigation.record_mismatch`)."""
        dev, tab, model = self.device, self.tables, self.model
        t_max, c, margin = self.env["max_action_len"], tab.c, self.env["error_margin"]
        mismatch = record_mismatch(tab, self.by_text, rec, t_max)
        rl_items = items_of(rec["txt_ids"], rec["txt_mask"], self.by_text)
        il_items = items_of(rec["il_txt_ids"], rec["il_txt_mask"], self.by_text)
        if None in rl_items or None in il_items:
            raise LookupError("a lane's instruction matches no item of the world")
        b, b_il = len(rl_items), len(il_items)
        bt = b + b_il
        # the teacher lanes, from the world
        teach = [teacher_episode(tab, it, t_max) for it in il_items]
        il_node = torch.tensor([x[0] for x in teach], device=dev)
        il_view = torch.tensor([x[1] for x in teach], device=dev)
        il_act = torch.tensor([x[2] for x in teach], device=dev)
        il_live = torch.tensor([x[3] for x in teach], device=dev)
        # the sampled lanes' starts and goals
        node = torch.tensor([tab.node(it["scan"], it["path"][0]) for it in rl_items], device=dev)
        view = torch.tensor([start_view(it["heading"]) for it in rl_items], device=dev)
        r_max = max(len(it["path"]) for it in rl_items)
        ref_cost = torch.full((b, self.feats.shape[0], r_max), math.inf, device=dev)
        for i, it in enumerate(rl_items):
            off = tab.offset[it["scan"]]
            dist = tab.dist[it["scan"]]
            ref = [tab.local[it["scan"]][v] for v in it["path"]]
            n = dist.shape[0]
            ref_cost[i, off:off + n, :len(ref)] = torch.as_tensor(dist[:, ref], device=dev)
        ref_len = torch.tensor([len(it["path"]) for it in rl_items], device=dev)
        bi = torch.arange(b, device=dev)

        def cost_at(nd):
            return ref_cost[bi, nd]

        def ndtw(dp):
            return torch.exp(-dp[bi, ref_len] / (margin * ref_len.float()))

        dp = torch.full((b, r_max + 1), math.inf, device=dev)
        dp[:, 0] = 0.0
        dp = dp_extend(dp, cost_at(node))
        last_ndtw = ndtw(dp)
        last_dist = cost_at(node)[bi, ref_len - 1]

        acts = rec["actions"].long()
        txt = torch.cat([rec["txt_ids"], rec["il_txt_ids"]]).long()
        txt_mask = torch.cat([rec["txt_mask"], rec["il_txt_mask"]]).bool()
        txt_emb = model.encode_text(txt, txt_mask)
        hist0 = model.init_history(bt, dev)
        d = hist0.shape[-1]
        hist = torch.cat([hist0[:, None], hist0.new_zeros(bt, t_max, d)], 1)
        hist_len = torch.ones(bt, dtype=torch.long, device=dev)
        ended = torch.zeros(b, dtype=torch.bool, device=dev)
        rl_logits, values, rewards, masks, il_logits, perturbed = [], [], [], [], [], []
        hpos = torch.arange(t_max + 1, device=dev)
        lanes = torch.arange(bt, device=dev)
        for t in range(t_max):
            live = ~ended
            node_all = torch.cat([node, il_node[:, t]])
            view_all = torch.cat([view, il_view[:, t]])
            live_all = torch.cat([live, il_live[:, t]])
            ob = tab.obs(self.feats, node_all, view_all)
            logits, state = model.plan(txt_emb, txt_mask, hist, hpos[None] < hist_len[:, None],
                                       ob["ob_img"], ob["ob_ang"], ob["ob_nav"], ob["ob_mask"])
            u = torch.rand(logits.shape, generator=self.streams.actions, device=dev)
            fi = torch.finfo(u.dtype)
            g = -torch.log(-torch.log(u.clamp(fi.tiny, 1.0 - fi.eps / 2)))
            perturbed.append((logits.detach()[:b] + g[:b]))
            a = torch.where(live, acts[:, t], c)
            action = torch.cat([a, il_act[:, t]])
            value = model.critic(state)
            act_ang = ob["ob_ang"][lanes, action]
            tok = model.encode_history(ob["hist_img"], act_ang, t, ob["pano_img"], ob["pano_ang"])
            hist = hist.index_put((lanes, torch.full_like(lanes, t + 1)), tok)
            hist_len = hist_len + live_all.long()
            rl_logits.append(logits[:b])
            il_logits.append(logits[b:])
            values.append(value[:b])
            masks.append(live.float())
            # the sampled lanes' transition and reward
            cand, point = ob["cand"][:b], ob["point"][:b]
            slot = a.clamp(0, c - 1)
            tgt = cand[bi, slot]
            moved = live & (a < c) & (tgt >= 0)
            stopped = a == c
            new_node = torch.where(moved, tgt, node)
            new_view = torch.where(moved, point[bi, slot], view)
            extend = live & ~stopped
            dp = torch.where(extend[:, None], dp_extend(dp, cost_at(new_node)), dp)
            cur_ndtw = ndtw(dp)
            nr = cur_ndtw - last_ndtw
            last_ndtw = cur_ndtw
            dist = cost_at(new_node)[bi, ref_len - 1]
            delta = -(dist - last_dist)
            stop_r = torch.where(dist < margin, 2.0 + cur_ndtw * 2.0, -2.0)
            move_r = torch.where(delta > 0.0, 1.0 + nr, -1.0 + nr)
            miss = (last_dist <= 1.0) & (dist - last_dist > 0.0)
            move_r = move_r - torch.where(miss, (1.0 - last_dist) * 2.0, 0.0)
            rewards.append(torch.where(live, torch.where(stopped, stop_r, move_r), 0.0))
            last_dist = dist
            ended = ended | (live & stopped)
            node, view = new_node, new_view
        # the critic's bootstrap on the final observation
        with torch.no_grad():
            ob = tab.obs(self.feats, node, view)
            txt_b = txt_emb[:, :b] if txt_emb.dim() == 4 else txt_emb[:b]
            _, last_state = model.plan(txt_b, txt_mask[:b], hist[:b],
                                       hpos[None] < hist_len[:b, None], ob["ob_img"],
                                       ob["ob_ang"], ob["ob_nav"], ob["ob_mask"])
            last_value = torch.where(ended, 0.0, model.critic(last_state))
        # losses
        tr = self.train
        il_targets = torch.where(il_live, il_act, IGNORE).T  # (T, B_il)
        il_lp = _masked_log_softmax(torch.stack(il_logits))
        valid = il_targets != IGNORE
        nll = -torch.gather(il_lp, -1, torch.where(valid, il_targets, 0)[..., None])[..., 0]
        l1 = torch.where(valid, nll, 0.0).sum() * tr["ml_weight"] / b_il
        logits_t = torch.stack(rl_logits)
        values_t = torch.stack(values)
        rewards_t = torch.stack(rewards).detach()
        masks_t = torch.stack(masks)
        acc, rets = last_value, []
        for t in range(t_max - 1, -1, -1):
            acc = acc * tr["gamma"] + rewards_t[t]
            rets.append(acc)
        returns = torch.stack(rets[::-1]).detach()
        lp = _masked_log_softmax(logits_t)
        rec_act = torch.where(masks_t.bool(), acts.T, c)
        act_lp = torch.gather(lp, -1, rec_act[..., None])[..., 0]
        adv = (returns - values_t).detach()
        policy = (-act_lp * adv * masks_t).sum()
        critic = 0.5 * (((returns - values_t) ** 2) * masks_t).sum()
        p = torch.exp(lp)
        ent = -(p * torch.where(torch.isfinite(lp), lp, 0.0)).sum(-1)
        l2 = (policy + critic - tr["entropy_loss_weight"] * (ent * masks_t).sum()) \
            / masks_t.sum().clamp(min=1.0)
        loss = l1 + l2
        names = list(self.w)
        cnames = list(self.cw)
        leaves = [self.w[k] for k in names] + [self.cw[k] for k in cnames]
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        g_model = {k: g for k, g in zip(names, grads[:len(names)]) if g is not None}
        g_critic = {k: g for k, g in zip(cnames, grads[len(names):]) if g is not None}
        norm = torch.linalg.vector_norm(torch.stack([g.norm() for g in g_model.values()]))
        scale = torch.where(norm < tr["grad_clip"], 1.0, tr["grad_clip"] / norm)
        g_model = {k: g * scale for k, g in g_model.items()}
        self.opt.step(g_model)
        self.copt.step(g_critic)
        return {"loss": float(loss.detach()), "grads": {**g_model, **{"critic." + k: g for k, g
                                                                      in g_critic.items()}},
                "perturbed": torch.stack(perturbed), "live": masks_t.bool(),
                "mismatch": mismatch}

    def params(self) -> Dict[str, torch.Tensor]:
        return {**self.w, **{"critic." + k: v for k, v in self.cw.items()}}

