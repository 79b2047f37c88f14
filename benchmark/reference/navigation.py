"""The navigation semantics of R2R, worked out again from the world.

Matterport's discretised panorama (``finetune_src/r2r/env.py``): 36 views,
12 headings of 30 degrees times elevations -30, 0 and +30 degrees, view
index = elevation level x 12 + heading index. A navigable neighbour is
seen from the view nearest its direction. The agent's observation is
[candidates | STOP | 36 views] (``agent_cmt.py:104-151``), candidates in
increasing viewpoint order, a candidate's angle relative to the current
view's heading, the panorama's angles relative to it too. A move goes to
the neighbour and looks along the view that saw it; STOP ends the
episode. The fixed-step teacher (``env.py:254-268``) walks the ground
truth path and stops at its end. The reward is R2R's shaped reward with
nDTW (``agent_cmt.py:407-445``).

Nodes are numbered globally, scans in sorted order, each scan's nodes in
the order of the world's ids: the layout of the feature table the
benchmark makes. Nothing here imports the program.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..world.generator import World, shortest_paths

VIEWS = 36
#: the teacher's target on a step after its episode ended
IGNORE = -100


class Tables:
    """Device tables over a world's global node numbering."""

    def __init__(self, world: World, max_candidates: int, angle_size: int, device):
        self.c, self.a, self.device = max_candidates, angle_size, device
        self.offset: Dict[str, int] = {}
        self.local: Dict[str, Dict[str, int]] = {}
        self.dist: Dict[str, np.ndarray] = {}
        n = sum(g.num_nodes for g in world.graphs.values())
        nbr = np.full((n, max_candidates), -1, np.int64)
        point = np.full((n, max_candidates), -1, np.int64)
        head = np.zeros((n, max_candidates), np.float32)
        elev = np.zeros((n, max_candidates), np.float32)
        at = 0
        for scan in world.scans:
            g = world.graphs[scan]
            self.offset[scan] = at
            self.local[scan] = {v: i for i, v in enumerate(g.node_ids)}
            self.dist[scan] = shortest_paths(g)[0].astype(np.float32)
            for u in range(g.num_nodes):
                vs = np.nonzero(g.adj[u])[0]
                if len(vs) > max_candidates:
                    raise ValueError(f"{scan} node {u}: degree {len(vs)} > {max_candidates}")
                d = g.positions[vs] - g.positions[u]
                h = np.arctan2(d[:, 0], d[:, 1])
                e = np.arctan2(d[:, 2], np.hypot(d[:, 0], d[:, 1]))
                nbr[at + u, :len(vs)] = vs + at
                head[at + u, :len(vs)] = h
                elev[at + u, :len(vs)] = e
                hi = np.round(h / (math.pi / 6)).astype(np.int64) % 12
                ei = np.clip(np.round(e / (math.pi / 6)), -1, 1).astype(np.int64) + 1
                point[at + u, :len(vs)] = ei * 12 + hi
            at += g.num_nodes
        self.nbr_np, self.point_np = nbr, point
        t = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
        self.nbr, self.point, self.head, self.elev = t(nbr), t(point), t(head), t(elev)
        self.view_ang = _view_angles(angle_size, device)

    def node(self, scan: str, viewpoint: str) -> int:
        return self.offset[scan] + self.local[scan][viewpoint]

    def obs(self, feats: torch.Tensor, node: torch.Tensor, view: torch.Tensor) -> dict:
        """The observation at global ``node`` looking along ``view``."""
        c = self.c
        pano = feats[node]  # (B, 36, D)
        cand = self.nbr[node]
        valid = cand >= 0
        point = torch.where(valid, self.point[node], 0)
        base = (view % 12).float() * (math.pi / 6.0)
        ang = _angles(self.head[node] - base[:, None], self.elev[node], self.a)
        ang = torch.where(valid[..., None], ang, 0.0)
        b, d = pano.shape[0], pano.shape[-1]
        cand_img = torch.gather(pano, 1, point[..., None].expand(b, c, d))
        cand_img = torch.where(valid[..., None], cand_img, 0.0)
        ob_img = torch.cat([cand_img, pano.new_zeros(b, 1, d), pano], 1)
        pano_ang = self.view_ang[view]
        ob_ang = torch.cat([ang, ang.new_zeros(b, 1, self.a), pano_ang], 1)
        ob_nav = torch.cat([valid.long(), torch.full((b, 1), 2, device=pano.device),
                            torch.zeros(b, VIEWS, dtype=torch.long, device=pano.device)], 1)
        claimed = ((point[..., None] == torch.arange(VIEWS, device=pano.device))
                   & valid[..., None]).any(1)
        ob_mask = torch.cat([valid, torch.ones(b, 1, dtype=torch.bool, device=pano.device),
                             ~claimed], 1)
        return {"ob_img": ob_img, "ob_ang": ob_ang, "ob_nav": ob_nav, "ob_mask": ob_mask,
                "hist_img": pano[torch.arange(b, device=pano.device), view],
                "pano_img": pano, "pano_ang": pano_ang, "cand": cand, "point": point}


def _angles(heading, elevation, size):
    base = torch.stack([torch.sin(heading), torch.cos(heading), torch.sin(elevation),
                        torch.cos(elevation)], dim=-1)
    return base.repeat((1,) * (base.dim() - 1) + (size // 4,))


def _view_angles(size: int, device) -> torch.Tensor:
    v = np.arange(VIEWS)
    head = (v % 12) * (math.pi / 6.0)
    elev = (v // 12 - 1) * (math.pi / 6.0)
    rel = (head[None, :] - head[:, None]).astype(np.float32)
    el = np.broadcast_to(elev[None, :], rel.shape).astype(np.float32)
    return _angles(torch.as_tensor(rel, device=device), torch.as_tensor(el, device=device), size)


def start_view(heading: float) -> int:
    """The horizon view nearest the start heading."""
    return 12 + int(np.round(heading / (math.pi / 6.0))) % 12


def teacher_episode(tables: Tables, item: dict, t_max: int) -> Tuple[List[int], List[int],
                                                                     List[int], List[bool]]:
    """(node, view, action, live) per step of the fixed-step teacher."""
    scan, path = item["scan"], item["path"]
    node = tables.node(scan, path[0])
    view = start_view(item["heading"])
    nbr, point = tables.nbr_np, tables.point_np
    nodes, views, acts, lives = [], [], [], []
    ended = False
    for t in range(t_max):
        nodes.append(node)
        views.append(view)
        lives.append(not ended)
        if ended:
            acts.append(tables.c)
            continue
        if t < len(path) - 1:
            nxt = tables.node(scan, path[t + 1])
            slot = int(np.nonzero(nbr[node] == nxt)[0][0])
            acts.append(slot)
            node, view = nxt, int(point[node, slot])
        else:
            acts.append(tables.c)
            ended = True
    return nodes, views, acts, lives


def dp_extend(dp: torch.Tensor, cost: torch.Tensor) -> torch.Tensor:
    """One row of the DTW table: cur[j] = cost[j-1] + min(prev[j],
    prev[j-1], cur[j-1]), cur[0] = inf."""
    cur = torch.full_like(dp[:, 0], math.inf)
    cols = [cur]
    for j in range(cost.shape[1]):
        cur = cost[:, j] + torch.minimum(torch.minimum(dp[:, j + 1], dp[:, j]), cur)
        cols.append(cur)
    return torch.stack(cols, dim=1)


def items_of(txt_ids: torch.Tensor, txt_mask: torch.Tensor, by_text: Dict[tuple, dict]
             ) -> List[Optional[dict]]:
    """The world's item behind each lane, matched by its instruction
    (None where no item has it)."""
    ids, mask = txt_ids.cpu().numpy(), txt_mask.cpu().numpy()
    return [by_text.get(tuple(int(x) for x in row[m])) for row, m in zip(ids, mask)]


def record_mismatch(tables: Tables, by_text: Dict[tuple, dict], rec: dict, t_max: int) -> int:
    """How many entries of one merged update's record (the keys of
    ``finetune.Replay.update``) the world does not bear out: a lane whose
    instruction is no item's; the teacher lanes' poses, actions, live
    masks and targets; the sampled lanes' starts, and every pose and live
    mask that their recorded actions lead to. The sampled actions
    themselves are the policy's, which only a replay of the model judges."""
    dev, c = rec["actions"].device, tables.c
    rl = items_of(rec["txt_ids"], rec["txt_mask"], by_text)
    il = items_of(rec["il_txt_ids"], rec["il_txt_mask"], by_text)
    if None in rl or None in il:
        return sum(it is None for it in rl + il) * (t_max + 1)
    teach = [teacher_episode(tables, it, t_max) for it in il]
    node, view, act, live = (torch.tensor([x[k] for x in teach], device=dev) for k in range(4))
    bad = int((node != rec["il_node_idx"].long()).sum())
    bad += int((view != rec["il_view_index"].long()).sum())
    bad += int((act != rec["il_actions"].long()).sum())
    bad += int((live != rec["il_step_mask"].bool()).sum())
    bad += int((torch.where(live, act, IGNORE) != rec["il_teacher"].long()).sum())
    node = torch.tensor([tables.node(it["scan"], it["path"][0]) for it in rl], device=dev)
    view = torch.tensor([start_view(it["heading"]) for it in rl], device=dev)
    bad += int((node != rec["start_node"].long()).sum())
    acts = rec["actions"].long()
    ended = torch.zeros(len(rl), dtype=torch.bool, device=dev)
    for t in range(t_max):
        live = ~ended
        bad += int((node != rec["node_idx"][:, t].long()).sum())
        bad += int((view != rec["view_index"][:, t].long()).sum())
        bad += int((live != rec["step_mask"][:, t].bool()).sum())
        a = torch.where(live, acts[:, t], c)
        slot = a.clamp(0, c - 1)
        tgt = tables.nbr[node, slot]
        moved = live & (a < c) & (tgt >= 0)
        node, view = torch.where(moved, tgt, node), torch.where(moved, tables.point[node, slot], view)
        ended = ended | (live & (a == c))
    return bad
