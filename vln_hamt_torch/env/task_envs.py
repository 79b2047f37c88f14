"""Task-variant environments: R2R-Back, REVERIE, CVDN (NDH).

Parity targets:
- ``R2RBackBatch`` (finetune_src/r2r/env.py:389-497): tuple distances
  (midstop, final) and midstop-aware success.
- ``ReverieNavRefBatch`` (finetune_src/reverie/env.py:132-269):
  object-goal navigation; goal = any viewpoint where the target object
  is visible; per-obs object candidates; RGS/RGSPL metrics;
  multi-endpoint path resampling.
- ``NDHNavBatch`` (finetune_src/cvdn/env.py): per-episode path choice
  (player path vs shortest to a random end pano), multi-end-pano goal,
  Goal Progress metric.

A copy of ``vln_hamt_tpu/env/task_envs.py`` (numpy only); the tests hold
the two equal on the same items and seeds.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..eval.metrics import cls_score, dtw_scores
from .observation import ObsBatch, _angle_table
from .r2r_env import R2RNavEnv


class R2RBackNavEnv(R2RNavEnv):
    """Return-to-start: succeed by visiting the midstop then returning.

    Items carry ``midstop``. Observations expose BOTH distances: the
    base ``dist_to_goal`` (final goal = start) plus ``dist_to_mid``
    stored on the ObsBatch (reference keeps a tuple, env.py:434-438).
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.gt_midstops = {
            x["instr_id"]: x["midstop"] for x in self.data
        }

    def _observe(self, pano_out: np.ndarray = None) -> ObsBatch:
        obs = super()._observe(pano_out=pano_out)
        dist_to_mid = np.zeros_like(obs.dist_to_goal)
        for i, item in enumerate(self.batch):
            g = self.graphs[item["scan"]]
            dist_to_mid[i] = g.dist[obs.node[i], g.index(item["midstop"])]
        obs.dist_to_mid = dist_to_mid  # dynamic attribute, host-side only
        return obs

    def _eval_item(self, scan: str, path: List[str], gt_path: List[str],
                   midstop: Optional[str], gt_midstop: str) -> Dict[str, float]:
        """env.py:441-468: success requires midstop AND final within margin."""
        g = self.graphs[scan]
        p = g.indices(path)
        gt = g.indices(gt_path)
        assert path[0] == gt_path[0]
        scores: Dict[str, float] = {}
        scores["nav_error"] = float(g.dist[p[-1], gt[-1]])
        scores["trajectory_steps"] = float(len(p) - 1)
        scores["trajectory_lengths"] = float(g.dist[p[:-1], p[1:]].sum()) if len(p) > 1 else 0.0
        gt_lengths = float(g.dist[gt[:-1], gt[1:]].sum()) if len(gt) > 1 else 0.0

        success = 0.0
        if midstop is not None:
            mid_ok = g.dist[g.index(midstop), g.index(gt_midstop)] <= self.error_margin
            end_ok = g.dist[p[-1], gt[-1]] <= self.error_margin
            if mid_ok and end_ok:
                success = 1.0
        scores["success"] = success
        scores["spl"] = success * gt_lengths / max(
            scores["trajectory_lengths"], gt_lengths, 0.01
        )
        scores.update(dtw_scores(g.dist, p, gt, success, self.error_margin))
        scores["CLS"] = cls_score(g.dist, p, gt, self.error_margin)
        return scores

    def eval_metrics(self, preds: List[dict]):
        per_item, details = [], {}
        for item in preds:
            instr_id = item["instr_id"]
            traj = [x[0] if isinstance(x, (tuple, list)) else x
                    for x in item["trajectory"]]
            scan, gt_path = self.gt_trajs[instr_id]
            scores = self._eval_item(scan, traj, gt_path, item.get("midstop"),
                                     self.gt_midstops[instr_id])
            per_item.append(scores)
            details[instr_id] = scores

        def m(key):
            return float(np.mean([s[key] for s in per_item])) if per_item else 0.0

        agg = {
            "steps": m("trajectory_steps"),
            "lengths": m("trajectory_lengths"),
            "nav_error": m("nav_error"),
            "sr": m("success") * 100,
            "spl": m("spl") * 100,
            "nDTW": m("nDTW") * 100,
            "SDTW": m("SDTW") * 100,
            "CLS": m("CLS") * 100,
        }
        return agg, details


# ----------------------------------------------------------------------
class ReverieNavEnv(R2RNavEnv):
    """Object-goal navigation with per-viewpoint object candidates.

    ``obj_db``: {(scan, viewpoint): {"fts": (K, Do), "viewindexs": (K,),
    "bboxes": (K, 4) xywh, "obj_ids": [str]}} — mirrors
    ``load_obj_database`` (reverie/data_utils.py:25-43).
    ``obj2viewpoint``: {scan_objid: [viewpoint ids]} from BBoxes.json.
    """

    def __init__(self, *args, obj_db=None, obj2viewpoint=None,
                 max_objects: int = 20, obj_feat_size: int = 768,
                 multi_endpoints: bool = False, multi_startpoints: bool = False,
                 image_sizes: Tuple[int, int] = (640, 480), **kwargs):
        super().__init__(*args, **kwargs)
        self.obj_db = obj_db or {}
        self.obj2viewpoint = obj2viewpoint or {}
        self.max_objects = max_objects
        self.obj_feat_size = obj_feat_size
        self.multi_endpoints = multi_endpoints
        self.multi_startpoints = multi_startpoints
        self.image_w, self.image_h = image_sizes
        self._clone_extra = {
            "obj_db": obj_db, "obj2viewpoint": obj2viewpoint,
            "max_objects": max_objects, "obj_feat_size": obj_feat_size,
            "multi_endpoints": multi_endpoints,
            "multi_startpoints": multi_startpoints,
            "image_sizes": image_sizes,
        }
        self.gt_trajs = {
            x["instr_id"]: (x["scan"], x["path"], x["objId"]) for x in self.data
        }
        self._np_rng = np.random.default_rng(kwargs.get("seed", 0))

    def _goal_viewpoints(self, scan: str, objid) -> List[str]:
        return self.obj2viewpoint.get(f"{scan}_{objid}", [])

    def _next_minibatch(self, batch_size=None) -> None:
        """Multi-endpoint path resampling (reverie/env.py:161-179)."""
        super()._next_minibatch(batch_size)
        if not self.multi_endpoints:
            return
        batch = [dict(item) for item in self.batch]
        for item in batch:
            g = self.graphs[item["scan"]]
            end_vps = self._goal_viewpoints(item["scan"], item["objId"])
            if not end_vps:
                continue
            end_vp = end_vps[int(self._np_rng.integers(len(end_vps)))]
            start_vp = item["path"][0]
            if self.multi_startpoints:
                end_i = g.index(end_vp)
                cands = [
                    v for v in range(g.num_nodes)
                    if 3 <= self._hops(g, v, end_i) <= 6
                ]
                if cands:
                    start_vp = g.node_ids[int(self._np_rng.choice(cands))]
            path = g.shortest_path(g.index(start_vp), g.index(end_vp))
            item["path"] = [g.node_ids[v] for v in path]
        self.batch = batch

    @staticmethod
    def _hops(g, src: int, dst: int) -> int:
        if not np.isfinite(g.dist[src, dst]):
            return -1
        n, cur = 0, src
        while cur != dst and n < 50:
            cur = int(g.next_hop[cur, dst])
            n += 1
        return n

    def _observe(self, pano_out: np.ndarray = None) -> ObsBatch:
        obs = super()._observe(pano_out=pano_out)
        b = len(self.batch)
        k = self.max_objects
        a = self.spec.angle_feat_size
        table_mode = self.feat_offsets is not None
        obj_ids: List[List[str]] = []
        if table_mode:
            # feature-table transport: object features/angles/positions
            # are gathered ON DEVICE from the resident object table
            # (data/feature_db.py:build_object_table); the host keeps
            # only the id lists (predObjId / ref-teacher bookkeeping)
            obs.obj_fts = obs.obj_angs = obs.obj_pos = obs.obj_mask = None
            for i in range(b):
                g = self.sim.graph(i)
                key = (self.batch[i]["scan"], g.node_ids[obs.node[i]])
                entry = self.obj_db.get(key)
                obj_ids.append(list(entry["obj_ids"][:k])
                               if entry is not None else [])
            obs.obj_ids = obj_ids
        else:
            obj_fts = np.zeros((b, k, self.obj_feat_size), np.float32)
            obj_angs = np.zeros((b, k, a), np.float32)
            obj_pos = np.zeros((b, k, 5), np.float32)
            obj_mask = np.zeros((b, k), bool)
            tab = _angle_table(a)
            for i in range(b):
                g = self.sim.graph(i)
                key = (self.batch[i]["scan"], g.node_ids[obs.node[i]])
                entry = self.obj_db.get(key)
                ids: List[str] = []
                if entry is not None:
                    n = min(len(entry["obj_ids"]), k)
                    obj_fts[i, :n] = entry["fts"][:n]
                    vidx = np.asarray(entry["viewindexs"][:n], np.int64)
                    obj_angs[i, :n] = tab[obs.view_index[i]][vidx]
                    obj_pos[i, :n] = self._obj_local_pos(entry["bboxes"][:n])
                    obj_mask[i, :n] = True
                    ids = list(entry["obj_ids"][:n])
                obj_ids.append(ids)
            obs.obj_fts = obj_fts
            obs.obj_angs = obj_angs
            obs.obj_pos = obj_pos
            obs.obj_mask = obj_mask
            obs.obj_ids = obj_ids
        # multi-goal distance: min over object-visible viewpoints
        # (reverie/env.py:206-214)
        for i, item in enumerate(self.batch):
            g = self.graphs[item["scan"]]
            goal_vps = self._goal_viewpoints(item["scan"], item["objId"])
            if goal_vps:
                obs.dist_to_goal[i] = min(
                    g.dist[obs.node[i], g.index(vp)] for vp in goal_vps
                )
            else:
                obs.dist_to_goal[i] = 0.0
        return obs

    def _obj_local_pos(self, bboxes: np.ndarray) -> np.ndarray:
        """xywh -> normalized (x1, y1, x2, y2, area)
        (reverie/data_utils.py:31-43)."""
        bb = np.asarray(bboxes, np.float32)
        x1 = bb[:, 0] / self.image_w
        y1 = bb[:, 1] / self.image_h
        x2 = (bb[:, 0] + bb[:, 2]) / self.image_w
        y2 = (bb[:, 1] + bb[:, 3]) / self.image_h
        area = (bb[:, 2] * bb[:, 3]) / (self.image_w * self.image_h)
        return np.stack([x1, y1, x2, y2, area], axis=1)

    def _eval_item(self, scan, path, gt_path, pred_objid, gt_objid):
        """reverie/env.py:218-243."""
        g = self.graphs[scan]
        p = g.indices(path)
        gt = g.indices(gt_path)
        assert path[0] == gt_path[0]
        scores: Dict[str, float] = {}
        scores["trajectory_steps"] = float(len(p) - 1)
        scores["trajectory_lengths"] = float(g.dist[p[:-1], p[1:]].sum()) if len(p) > 1 else 0.0
        gt_lengths = float(g.dist[gt[:-1], gt[1:]].sum()) if len(gt) > 1 else 0.0

        goal_vps = set(self._goal_viewpoints(scan, gt_objid))
        assert goal_vps, f"{scan}_{gt_objid}"
        scores["success"] = float(path[-1] in goal_vps)
        scores["oracle_success"] = float(any(x in goal_vps for x in path))
        scores["spl"] = scores["success"] * gt_lengths / max(
            scores["trajectory_lengths"], gt_lengths, 0.01
        )
        scores["rgs"] = float(str(pred_objid) == str(gt_objid))
        scores["rgspl"] = scores["rgs"] * gt_lengths / max(
            scores["trajectory_lengths"], gt_lengths, 0.01
        )
        return scores

    def eval_metrics(self, preds: List[dict]):
        per_item, details = [], {}
        for item in preds:
            instr_id = item["instr_id"]
            traj = [x[0] if isinstance(x, (tuple, list)) else x
                    for x in item["trajectory"]]
            scan, gt_path, gt_objid = self.gt_trajs[instr_id]
            scores = self._eval_item(scan, traj, gt_path,
                                     item.get("predObjId"), gt_objid)
            per_item.append(scores)
            details[instr_id] = scores

        def m(key):
            return float(np.mean([s[key] for s in per_item])) if per_item else 0.0

        agg = {
            "steps": m("trajectory_steps"),
            "lengths": m("trajectory_lengths"),
            "sr": m("success") * 100,
            "oracle_sr": m("oracle_success") * 100,
            "spl": m("spl") * 100,
            "rgs": m("rgs") * 100,
            "rgspl": m("rgspl") * 100,
        }
        return agg, details


# ----------------------------------------------------------------------
class CVDNNavEnv(R2RNavEnv):
    """Dialog navigation (NDH): multi-end-pano goals, Goal Progress.

    Items: {instr_id, scan, start_pano, start_heading, end_panos,
    nav_steps, nav_idx, instr_encoding}. Per-minibatch the supervision
    path is resampled (cvdn/env.py:31-46).
    """

    def __init__(self, *args, use_player_path: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        self.use_player_path = use_player_path
        self._clone_extra = {"use_player_path": use_player_path}
        self.gt_trajs = {
            x["instr_id"]: (x["scan"], x["end_panos"]) for x in self.data
            if "end_panos" in x
        }
        self._np_rng = np.random.default_rng(kwargs.get("seed", 0))

    def _prepare_item(self, item: dict) -> dict:
        """Resample the supervision path for one item (cvdn/env.py:31-46)."""
        item = dict(item)
        g = self.graphs[item["scan"]]
        if "end_panos" in item:
            if self.use_player_path and self._np_rng.random() > 0.5:
                item["path"] = item["nav_steps"][item["nav_idx"]:]
            else:
                end = item["end_panos"][int(self._np_rng.integers(len(item["end_panos"])))]
                path = g.shortest_path(g.index(item["start_pano"]), g.index(end))
                item["path"] = [g.node_ids[v] for v in path]
        else:
            item["path"] = [item["start_pano"]]
        item["heading"] = item.get("start_heading", 0.0)
        return item

    def _next_minibatch(self, batch_size=None) -> None:
        super()._next_minibatch(batch_size)
        self.batch = [self._prepare_item(item) for item in self.batch]

    def load_item(self, slot: int, item: dict) -> None:
        # raw NDH items carry start_pano/end_panos, not a path; packed
        # eval swaps items in directly so derive the path here too
        super().load_item(slot, self._prepare_item(item))

    def _observe(self, pano_out: np.ndarray = None) -> ObsBatch:
        obs = super()._observe(pano_out=pano_out)
        # multi-goal distance: min over end panos (cvdn/env.py:80-87)
        for i, item in enumerate(self.batch):
            g = self.graphs[item["scan"]]
            if "end_panos" in item:
                obs.dist_to_goal[i] = min(
                    g.dist[obs.node[i], g.index(vp)] for vp in item["end_panos"]
                )
            else:
                obs.dist_to_goal[i] = 0.0
        return obs

    def _eval_item(self, scan, path, end_panos):
        """cvdn/env.py:91-108; gp = gt length - remaining distance."""
        g = self.graphs[scan]
        p = g.indices(path)
        ends = [g.index(v) for v in end_panos]
        scores: Dict[str, float] = {}
        scores["trajectory_steps"] = float(len(p) - 1)
        scores["trajectory_lengths"] = float(g.dist[p[:-1], p[1:]].sum()) if len(p) > 1 else 0.0
        gt_lengths = float(min(g.dist[p[0], e] for e in ends))
        end_set = set(end_panos)
        scores["success"] = float(path[-1] in end_set)
        scores["oracle_success"] = float(any(x in end_set for x in path))
        scores["spl"] = scores["success"] * gt_lengths / max(
            scores["trajectory_lengths"], gt_lengths, 0.01
        )
        scores["gp"] = gt_lengths - float(min(g.dist[p[-1], e] for e in ends))
        return scores

    def eval_metrics(self, preds: List[dict]):
        per_item, details = [], {}
        for item in preds:
            instr_id = item["instr_id"]
            traj = [x[0] if isinstance(x, (tuple, list)) else x
                    for x in item["trajectory"]]
            scan, end_panos = self.gt_trajs[instr_id]
            scores = self._eval_item(scan, traj, end_panos)
            per_item.append(scores)
            details[instr_id] = scores

        def m(key):
            return float(np.mean([s[key] for s in per_item])) if per_item else 0.0

        agg = {
            "steps": m("trajectory_steps"),
            "lengths": m("trajectory_lengths"),
            "sr": m("success") * 100,
            "oracle_sr": m("oracle_success") * 100,
            "spl": m("spl") * 100,
            "gp": m("gp"),
        }
        return agg, details
