"""Fixed-shape observations, compact on host / expanded on device.

The redesign of the reference's per-step observation tensorization
(``agent_cmt.py:104-151``), in two parts:

**Static layout.** Every observation has one shape:

    slot 0 .. C-1 : candidate slots (padded, masked)       nav_type 1
    slot C        : STOP                                   nav_type 2
    slot C+1 .. C+36 : the full 36-view panorama context   nav_type 0

Views already represented by a candidate are masked out of the panorama
region (the reference's ``feature[~cand_pointids]`` exclusion); STOP is
a constant slot, so action semantics are uniform tensors. Ordering
differs from the reference but obs tokens carry no positional
embedding, so attention is permutation-invariant to it.

**Compact transport.** Candidate features are rows of the panorama
feature matrix, so an :class:`ObsBatch` stores only:

    pano_feat (B, 36, D)   the feature matrix (it IS hist_pano_img)
    view_index (B,)        current discretized view
    cand_point (B, C)      each candidate's representative view (-1 pad)
    cand_ang (B, C, A)     candidate angle features (tiny)

and the full layout (ob_img / ob_ang / nav types / masks / history
features) is gathered on the device
(:func:`vln_hamt_torch.agents.rollout.make_expand_obs`). Host-side numpy
expansion (:meth:`ObsBatch.full`) exists for tests and host consumers.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..data.angle import all_point_angle_feature, angle_features, view_heading
from ..data.nav_graph import NavGraph
from .sim import GraphSimulator

IGNORE_ID = -100


@dataclasses.dataclass(frozen=True)
class ObsSpec:
    views: int = 36
    max_candidates: int = 14
    image_feat_size: int = 768
    angle_feat_size: int = 4
    # 'pano': candidates + STOP + panorama context (agent_cmt.py:104-151)
    # 'cand': candidates + STOP only (the reference's ob_type='cand'
    #         ablation, agent_cmt.py:153-171) — same static layout, the
    #         panorama region is attention-masked out
    ob_type: str = "pano"

    @property
    def num_ob_tokens(self) -> int:
        return self.max_candidates + 1 + self.views

    @property
    def stop_slot(self) -> int:
        return self.max_candidates


_ANGLE_TABLE_CACHE: Dict[int, np.ndarray] = {}


def _angle_table(angle_feat_size: int) -> np.ndarray:
    tab = _ANGLE_TABLE_CACHE.get(angle_feat_size)
    if tab is None:
        tab = all_point_angle_feature(angle_feat_size)  # (36, 36, A)
        _ANGLE_TABLE_CACHE[angle_feat_size] = tab
    return tab


@dataclasses.dataclass
class FullObs:
    """Host-expanded observation arrays (the device layout, in numpy)."""

    ob_img: np.ndarray  # (B, N, D)
    ob_ang: np.ndarray  # (B, N, A)
    ob_nav: np.ndarray  # (B, N) int32
    ob_mask: np.ndarray  # (B, N) bool
    hist_img: np.ndarray  # (B, D)
    hist_pano_img: np.ndarray  # (B, V, D)
    hist_pano_ang: np.ndarray  # (B, V, A)


@dataclasses.dataclass
class ObsBatch:
    """One step's observations (compact form; see module docstring)."""

    spec: ObsSpec
    pano_feat: np.ndarray  # (B, V, D) float32
    view_index: np.ndarray  # (B,) int32
    cand_node: np.ndarray  # (B, C) int32, -1 pad
    cand_point: np.ndarray  # (B, C) int32 representative views, -1 pad
    cand_ang: np.ndarray  # (B, C, A) float32
    teacher: np.ndarray  # (B,) int32 action slot (stop_slot / IGNORE_ID)
    node: np.ndarray  # (B,) int32
    dist_to_goal: np.ndarray  # (B,) float32
    # task-variant extras (host-side), filled by the task envs
    dist_to_mid: Optional[np.ndarray] = None  # R2R-Back (B,)
    obj_fts: Optional[np.ndarray] = None  # REVERIE (B, K, Do)
    obj_angs: Optional[np.ndarray] = None  # (B, K, A)
    obj_pos: Optional[np.ndarray] = None  # (B, K, 5)
    obj_mask: Optional[np.ndarray] = None  # (B, K)
    obj_ids: Optional[list] = None  # per-sample object id strings
    _full: Optional[FullObs] = dataclasses.field(default=None, repr=False)

    @property
    def batch_size(self) -> int:
        return self.view_index.shape[0]

    # compatibility alias for MatterSim naming
    @property
    def cand_view(self) -> np.ndarray:
        return self.cand_point

    # ----------------------------------------------------- lazy expand
    def full(self) -> FullObs:
        if self._full is None:
            self._full = expand_obs_np(self.spec, self.pano_feat,
                                       self.view_index, self.cand_point,
                                       self.cand_ang)
        return self._full

    @property
    def ob_img(self) -> np.ndarray:
        return self.full().ob_img

    @property
    def ob_ang(self) -> np.ndarray:
        return self.full().ob_ang

    @property
    def ob_nav(self) -> np.ndarray:
        return self.full().ob_nav

    @property
    def ob_mask(self) -> np.ndarray:
        return self.full().ob_mask

    @property
    def hist_img(self) -> np.ndarray:
        return self.full().hist_img

    @property
    def hist_pano_img(self) -> np.ndarray:
        return self.full().hist_pano_img

    @property
    def hist_pano_ang(self) -> np.ndarray:
        return self.full().hist_pano_ang


@dataclasses.dataclass
class EpisodeBatch:
    """A full episode, time-stacked in compact form.

    Under teacher forcing the trajectory is the ground-truth path, so
    all observations are known upfront. Feature payload is O(B*T*V*D)
    once (the pano matrices), not O(B*T*N*D) twice.
    """

    txt_ids: np.ndarray  # (B, L) int32
    txt_mask: np.ndarray  # (B, L) bool
    pano_feat: np.ndarray  # (B, T, V, D); None in feature-table mode
    view_index: np.ndarray  # (B, T)
    cand_point: np.ndarray  # (B, T, C)
    cand_ang: np.ndarray  # (B, T, C, A)
    actions: np.ndarray  # (B, T) int32 action slots taken
    step_mask: np.ndarray  # (B, T) bool valid (pre-stop) steps
    teacher: np.ndarray  # (B, T) int32 supervision (IGNORE_ID invalid)
    # feature-table mode: global viewpoint rows into a device-resident
    # (N, V, D) table; pano features are gathered ON DEVICE, so the host
    # ships (B, T) ints instead of (B, T, V, D) floats
    node_idx: np.ndarray = None  # (B, T) int32, or None


def expand_obs_np(
    spec: ObsSpec,
    pano_feat: np.ndarray,  # (..., V, D)
    view_index: np.ndarray,  # (...,)
    cand_point: np.ndarray,  # (..., C)
    cand_ang: np.ndarray,  # (..., C, A)
) -> FullObs:
    """Numpy twin of the on-device expansion (tests / host consumers)."""
    c = spec.max_candidates
    v = spec.views
    lead = pano_feat.shape[:-2]
    d, a = spec.image_feat_size, spec.angle_feat_size

    valid = cand_point >= 0
    idx = np.where(valid, cand_point, 0)
    cand_feats = np.take_along_axis(pano_feat, idx[..., None], axis=-2)
    cand_feats = np.where(valid[..., None], cand_feats, 0.0)

    stop_img = np.zeros(lead + (1, d), np.float32)
    ob_img = np.concatenate([cand_feats, stop_img, pano_feat], axis=-2)

    tab = _angle_table(a)  # (36, 36, A)
    pano_ang = tab[view_index]  # (..., V, A)
    stop_ang = np.zeros(lead + (1, a), np.float32)
    ob_ang = np.concatenate(
        [np.where(valid[..., None], cand_ang, 0.0), stop_ang, pano_ang], axis=-2
    )

    ob_nav = np.zeros(lead + (spec.num_ob_tokens,), np.int32)
    ob_nav[..., :c] = valid.astype(np.int32)
    ob_nav[..., c] = 2

    # claimed[view] = any valid candidate represented by that view
    # (one-hot reduce — a scatter would let padded writes clobber real
    # ones at clipped index 0)
    onehot = (idx[..., None] == np.arange(v)) & valid[..., None]
    claimed = onehot.any(axis=-2)
    if spec.ob_type == "cand":
        pano_region = np.zeros(lead + (v,), bool)
    else:
        pano_region = ~claimed
    ob_mask = np.concatenate(
        [valid, np.ones(lead + (1,), bool), pano_region], axis=-1
    )

    hist_img = np.take_along_axis(
        pano_feat, view_index[..., None, None], axis=-2
    ).squeeze(-2)

    return FullObs(
        ob_img=ob_img.astype(np.float32), ob_ang=ob_ang.astype(np.float32),
        ob_nav=ob_nav, ob_mask=ob_mask, hist_img=hist_img,
        hist_pano_img=pano_feat, hist_pano_ang=pano_ang.astype(np.float32),
    )


def teacher_slot(cand_node: np.ndarray, stop_slot: int, teacher_node: int,
                 current_node: int) -> int:
    """Action slot of the teacher move (parity: agent_cmt.py:192-211).

    Returns ``IGNORE_ID`` when the fixed-step teacher node is neither a
    candidate nor the current node — which happens whenever the agent
    has wandered off the ground-truth schedule (RL sampling / eval). The
    reference never queries the teacher in that regime (``train_ml is
    None``); keeping it lenient here lets one obs assembly serve IL, RL
    and eval. On-path IL supervision asserts non-ignore downstream.
    """
    hits = np.nonzero(cand_node == teacher_node)[0]
    if len(hits):
        return int(hits[0])
    if teacher_node == current_node:
        return stop_slot
    return IGNORE_ID


def make_obs_batch(
    spec: ObsSpec,
    sim: GraphSimulator,
    features,  # per-slot (V, D) pano features, or None (table mode)
    goals: Sequence[int],
    teacher_nodes: Sequence[int],
    pano_out: np.ndarray = None,  # optional (B, V, D) fp32 destination
) -> ObsBatch:
    b = len(goals)
    c = spec.max_candidates
    a = spec.angle_feat_size

    if features is None:
        # feature-table mode: the episode ships node indices and the
        # device gathers features; no host-side feature work at all
        pano_feat = None
    elif pano_out is not None:
        # write features straight into a caller-owned episode buffer
        # (avoids the extra full-batch copy in episode assembly)
        np.stack(features, out=pano_out)
        pano_feat = pano_out
    else:
        pano_feat = np.stack(features).astype(np.float32, copy=False)
    view_index = sim.view_index[:b].astype(np.int32, copy=True)
    node = sim.node[:b].copy()
    cand_node = np.full((b, c), -1, np.int32)
    cand_point = np.full((b, c), -1, np.int32)
    cand_head = np.zeros((b, c), np.float32)
    cand_elev = np.zeros((b, c), np.float32)
    cand_valid = np.zeros((b, c), bool)
    teacher = np.zeros((b,), np.int32)
    dist_to_goal = np.zeros((b,), np.float32)

    for i in range(b):
        g = sim.graph(i)
        u = int(node[i])
        nbrs = g.nbr_index[u]
        valid = nbrs >= 0
        deg = int(valid.sum())
        if deg > c:
            raise ValueError(
                f"scan {g.scan} node {u} has degree {deg} > max_candidates {c}"
            )
        cand_node[i, :deg] = nbrs[valid]
        cand_point[i, :deg] = g.nbr_point_id[u][valid]
        cand_head[i, :deg] = g.nbr_heading[u][valid]
        cand_elev[i, :deg] = g.nbr_elevation[u][valid]
        cand_valid[i, :deg] = True
        teacher[i] = teacher_slot(cand_node[i], spec.stop_slot,
                                  int(teacher_nodes[i]), u)
        dist_to_goal[i] = g.dist[u, goals[i]]

    # one vectorized trig pass for the whole batch (the per-slot loop was
    # the host-assembly hot spot: B small np.stack calls per observe)
    base_heading = view_heading(view_index).astype(np.float32)
    cand_ang = angle_features(cand_head - base_heading[:, None], cand_elev, a)
    cand_ang[~cand_valid] = 0.0

    return ObsBatch(
        spec=spec, pano_feat=pano_feat, view_index=view_index,
        cand_node=cand_node, cand_point=cand_point, cand_ang=cand_ang,
        teacher=teacher, node=node, dist_to_goal=dist_to_goal,
    )
