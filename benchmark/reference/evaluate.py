"""Greedy evaluation judged decision by decision.

The program's predicted trajectory of an item is its output. The
reference walks it from the item's start: each step's move must go to a
neighbour, looking along the view that sees it; the trajectory's end is
a STOP unless the episode used every step. At each decision it runs the
model over the same history (teacher-forced along the trajectory, in
evaluation mode) and reads how far the logit of the program's action
lies below the best: greedy decoding takes the best, so the gap is
rounding only.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

from .hamt import HAMT, Params
from .navigation import Tables, start_view


def _pose_view(heading: float, elevation: float) -> int:
    h = int(np.round(heading / (math.pi / 6.0))) % 12
    e = int(np.clip(np.round(elevation / (math.pi / 6.0)), -1, 1)) + 1
    return e * 12 + h


def decisions(tables: Tables, item: dict, traj: list, t_max: int):
    """(actions, mismatches): the action of each step along ``traj``
    (a list of (viewpoint, heading, elevation)) and the count of its
    poses that the world does not bear out."""
    scan, bad = item["scan"], 0
    node = tables.node(scan, item["path"][0])
    if traj[0][0] != item["path"][0] or _pose_view(traj[0][1], traj[0][2]) != \
            start_view(item["heading"]):
        bad += 1
    acts = []
    for vp, h, e in traj[1:]:
        local = tables.local[scan].get(vp)
        hits = np.nonzero(tables.nbr_np[node] == tables.offset[scan] + (local or 0))[0]
        if local is None or len(hits) == 0:
            return acts, bad + 1
        slot = int(hits[0])
        if tables.point_np[node, slot] != _pose_view(h, e):
            bad += 1
        acts.append(slot)
        node = tables.offset[scan] + local
    if len(acts) > t_max:
        return acts[:t_max], bad + 1
    if len(acts) < t_max:
        acts.append(tables.c)  # the STOP that ended the episode
    return acts, bad


def judge(cfg: dict, tables: Tables, feats: torch.Tensor, w: Params, cw: Params,
          items: List[dict], trajs: List[list]) -> dict:
    """Reference logits along each trajectory: ``gap`` (the widest gap of
    a program action below the best), ``logits`` (T, B, N) and ``live``
    (T, B) for a second side's choices, ``mismatch``."""
    m, env = cfg["model"], cfg["env"]
    t_max, c, dev = env["max_action_len"], tables.c, feats.device
    model = HAMT(m, w, cw, training=False)
    acts, mismatch = [], 0
    for it, tr in zip(items, trajs):
        a, bad = decisions(tables, it, tr, t_max)
        acts.append(a)
        mismatch += bad
    b = len(items)
    l_max = env["max_instr_len"]
    ids = torch.zeros((b, l_max), dtype=torch.long, device=dev)
    mask = torch.zeros((b, l_max), dtype=torch.bool, device=dev)
    for i, it in enumerate(items):
        enc = it["instr_encoding"][:l_max]
        ids[i, :len(enc)] = torch.as_tensor(enc, device=dev)
        mask[i, :len(enc)] = True
    node = torch.tensor([tables.node(it["scan"], it["path"][0]) for it in items], device=dev)
    view = torch.tensor([start_view(it["heading"]) for it in items], device=dev)
    act = torch.full((b, t_max), c, dtype=torch.long, device=dev)
    live = torch.zeros((b, t_max), dtype=torch.bool, device=dev)
    for i, a in enumerate(acts):
        act[i, :len(a)] = torch.as_tensor(a, device=dev)
        live[i, :len(a)] = True
    lanes = torch.arange(b, device=dev)
    hpos = torch.arange(t_max + 1, device=dev)
    logits_all = []
    with torch.no_grad():
        txt = model.encode_text(ids, mask)
        hist0 = model.init_history(b, dev)
        hist = torch.cat([hist0[:, None], hist0.new_zeros(b, t_max, hist0.shape[-1])], 1)
        hist_len = torch.ones(b, dtype=torch.long, device=dev)
        for t in range(t_max):
            ob = tables.obs(feats, node, view)
            logits, _ = model.plan(txt, mask, hist, hpos[None] < hist_len[:, None],
                                   ob["ob_img"], ob["ob_ang"], ob["ob_nav"], ob["ob_mask"])
            logits_all.append(logits)
            a = torch.where(live[:, t], act[:, t], c)
            tok = model.encode_history(ob["hist_img"], ob["ob_ang"][lanes, a], t,
                                       ob["pano_img"], ob["pano_ang"])
            hist = hist.index_put((lanes, torch.full_like(lanes, t + 1)), tok)
            hist_len = hist_len + live[:, t].long()
            moved = live[:, t] & (a < c)
            slot = a.clamp(0, c - 1)
            node = torch.where(moved, ob["cand"][lanes, slot], node)
            view = torch.where(moved, ob["point"][lanes, slot], view)
    logits_t = torch.stack(logits_all)  # (T, B, N)
    live_t = live.T
    chosen = torch.gather(logits_t, -1, act.T[..., None])[..., 0]
    gap = (logits_t.max(-1).values - chosen)[live_t]
    return {"gap": float(gap.max()) if gap.numel() else 0.0, "logits": logits_t,
            "live": live_t, "mismatch": mismatch, "decisions": int(live_t.sum())}
