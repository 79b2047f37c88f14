"""Expert-trajectory dataset for proxy-task pretraining: a copy of
``vln_hamt_tpu/pretrain/trajectory_data.py`` (numpy only), which gives
the same arrays for the same records and seed.

Parity target: ``MultiStepNavData`` (``pretrain_src/data/r2r_data.py:
95-346``). A trajectory record holds the expert path, the discretized
view index at each step, the action's representative view index and its
relative angles — the reference reads these from preprocessed JSONL
(``traj_files``); we additionally synthesize them directly from a
:class:`~vln_hamt_torch.data.fixtures.SyntheticWorld` so pretraining runs
hermetically.

Shape policy: every example is padded to ``max_hist_len`` history
steps at assembly time — the reference pads per batch to the batch max
(``r2r_tasks.py`` collates), which produces data-dependent shapes.

Observations come in the reference's two layouts
(``r2r_data.py:180-188``, selected by ``ob_cand_pano_view``):

- pano (default): 36 views + STOP = 37 fixed tokens
  (``get_ob_pano_view``, r2r_data.py:204-220), candidates marked by
  nav type rather than reordered;
- candidate-first (``get_ob_cand_pano_view``, r2r_data.py:222-261,
  required by ``config/pretrain_rxr.json:31``): candidate views first
  with exact edge angles, then STOP, then the non-candidate views;
  the SAP label becomes the candidate SLOT index. Width is padded to
  ``NUM_VIEWS + 1 + ob_cand_extra`` (two candidates may share a
  discretized view, making the token count data-dependent — the
  reference pads per batch; we pad to a static cap and mask).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..data.angle import all_point_angle_feature, angle_features, view_heading
from ..data.fixtures import SyntheticWorld
from ..data.nav_graph import NavGraph
from ..env.sim import snap_heading_to_view

IGNORE_ID = -100
NUM_VIEWS = 36


@dataclasses.dataclass
class TrajRecord:
    scan: str
    path: List[str]  # viewpoint ids
    path_viewindex: np.ndarray  # (T,) int32 view index at each step
    action_viewindex: np.ndarray  # (T,) int32 target view index, -1 = stop
    rel_act_angles: np.ndarray  # (T, 2) float32 (heading rel base, abs elev)
    instr_ids: List[str]
    instr_encodings: List[List[int]]


def standardize_radians(x):
    """Wrap to [-pi, pi) (r2r_tasks.py:438-442)."""
    x = np.mod(np.asarray(x, dtype=np.float64), 2 * np.pi)
    return np.where(x >= np.pi, x - 2 * np.pi, x).astype(np.float32)


def make_synthetic_trajectories(world: SyntheticWorld) -> List[TrajRecord]:
    """Derive expert-trajectory records from a synthetic world's items."""
    records = []
    for item in world.instr_data:
        g = world.graphs[item["scan"]]
        path_idx = g.indices(item["path"])
        t_len = len(path_idx)
        view_idx = np.zeros((t_len,), np.int32)
        act_view = np.full((t_len,), -1, np.int32)
        rel_ang = np.zeros((t_len, 2), np.float32)
        view_idx[0] = snap_heading_to_view(item.get("heading", 0.0))
        for t in range(t_len - 1):
            u, v = int(path_idx[t]), int(path_idx[t + 1])
            j = int(np.nonzero(g.nbr_index[u] == v)[0][0])
            pid = int(g.nbr_point_id[u, j])
            act_view[t] = pid
            base_h = float(view_heading(view_idx[t]))
            rel_ang[t, 0] = standardize_radians(g.nbr_heading[u, j] - base_h)
            rel_ang[t, 1] = g.nbr_elevation[u, j]
            view_idx[t + 1] = pid
        records.append(
            TrajRecord(
                scan=item["scan"],
                path=list(item["path"]),
                path_viewindex=view_idx,
                action_viewindex=act_view,
                rel_act_angles=rel_ang,
                instr_ids=[item["instr_id"]],
                instr_encodings=[list(item["instr_encoding"])],
            )
        )
    return records


def load_trajectory_jsonl(traj_files: Sequence[str]) -> List[TrajRecord]:
    """Reference JSONL trajectory format (r2r_data.py:125-136)."""
    records = []
    for path in traj_files:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                item = json.loads(line)
                records.append(
                    TrajRecord(
                        scan=item["scan"],
                        path=item["path"],
                        path_viewindex=np.asarray(item["path_viewindex"], np.int32),
                        action_viewindex=np.asarray(item["action_viewindex"], np.int32),
                        rel_act_angles=np.asarray(item["rel_act_angles"], np.float32),
                        instr_ids=item["instr_ids"],
                        instr_encodings=item["instr_encodings"],
                    )
                )
    return records


class TrajectoryDataset:
    """Fixed-shape example assembly over trajectory records."""

    def __init__(
        self,
        records: List[TrajRecord],
        graphs: Dict[str, NavGraph],
        feat_db,  # FeatureDB returning (36, image_feat_size [+ prob_size])
        image_feat_size: int = 768,
        image_prob_size: int = 1000,
        angle_feat_size: int = 4,
        max_txt_len: int = 80,
        max_hist_len: int = 8,  # max history steps (reference caps at 30)
        hist_enc_pano: bool = True,
        ob_cand_pano_view: bool = False,
        ob_cand_extra: int = 4,
    ):
        self.records = records
        self.graphs = graphs
        self.feat_db = feat_db
        self.image_feat_size = image_feat_size
        self.image_prob_size = image_prob_size
        self.angle_feat_size = angle_feat_size
        self.max_txt_len = max_txt_len
        self.max_hist_len = max_hist_len
        self.hist_enc_pano = hist_enc_pano
        self.ob_cand_pano_view = ob_cand_pano_view
        self.ob_cand_extra = ob_cand_extra
        self.angle_table = all_point_angle_feature(angle_feat_size)  # (36,36,A)
        #: scan -> global feature-table row offset; set via
        #: :meth:`set_feat_offsets` to switch example assembly to
        #: INDEX mode: examples then carry int32 table rows instead of
        #: materialized features, and the model gathers/expands them on
        #: device from the resident table (model.py:expand_index_batch)
        #: — the pretrain twin of the fine-tune feature-table transport.
        self.feat_offsets: Optional[Dict[str, int]] = None

        # (i_traj, j_instr, path_len) and (i_traj, j_instr, t) refs
        # (r2r_data.py:126-136)
        self.traj_refer: List[Tuple[int, int, int]] = []
        self.traj_step_refer: List[Tuple[int, int, int]] = []
        for n, rec in enumerate(self.records):
            path_len = min(len(rec.path), self.max_hist_len)
            for j in range(len(rec.instr_encodings)):
                self.traj_refer.append((n, j, path_len))
                self.traj_step_refer.extend(
                    (n, j, t) for t in range(path_len)
                )

    # ------------------------------------------------------------------
    def _features(self, scan: str, vp: str) -> np.ndarray:
        return self.feat_db.get(scan, vp)

    def set_feat_offsets(self, offsets: Dict[str, int]) -> None:
        """Switch to index-mode assembly (resident feature table;
        layout from data.feature_db.build_feature_table)."""
        self.feat_offsets = offsets

    def history_arrays(self, rec: TrajRecord, t_cur: int,
                       want_probs: bool = False) -> Dict[str, np.ndarray]:
        """History features for steps < t_cur, padded to max_hist_len
        (r2r_data.py:264-315). Index mode ships (H,) table rows + view
        indices instead of the (H, 36, D) feature stacks — the angles,
        masks and lengths are identical in both modes."""
        h = self.max_hist_len
        d, a = self.image_feat_size, self.angle_feat_size
        index_mode = self.feat_offsets is not None
        out = {
            "hist_ang": np.zeros((h, a), np.float32),
            "hist_mask": np.zeros((h + 1,), bool),  # +1 for [CLS]
            "hist_len": t_cur,
        }
        out["hist_mask"][: t_cur + 1] = True
        if index_mode:
            out["hist_node"] = np.zeros((h,), np.int32)
            out["hist_view"] = np.zeros((h,), np.int32)
            g = self.graphs[rec.scan]
            off = self.feat_offsets[rec.scan]
        else:
            out["hist_img"] = np.zeros((h, d), np.float32)
            if self.hist_enc_pano:
                out["hist_pano_img"] = np.zeros((h, NUM_VIEWS, d), np.float32)
                out["hist_pano_ang"] = np.zeros((h, NUM_VIEWS, a), np.float32)
            if want_probs:
                out["hist_img_probs"] = np.zeros((h, self.image_prob_size),
                                                 np.float32)

        for t in range(t_cur):
            vp = rec.path[t]
            vidx = int(rec.path_viewindex[t])
            if t != len(rec.path) - 1:  # non-stop step has an action angle
                out["hist_ang"][t] = angle_features(
                    rec.rel_act_angles[t, 0], rec.rel_act_angles[t, 1], a
                )
            if index_mode:
                out["hist_node"][t] = off + g.index(vp)
                out["hist_view"][t] = vidx
                continue
            fts = self._features(rec.scan, vp)
            out["hist_img"][t] = fts[vidx, : self.image_feat_size]
            if self.hist_enc_pano:
                out["hist_pano_img"][t] = fts[:, : self.image_feat_size]
                out["hist_pano_ang"][t] = self.angle_table[vidx]
            if want_probs:
                logits = fts[vidx, self.image_feat_size:
                             self.image_feat_size + self.image_prob_size]
                e = np.exp(logits - logits.max())
                out["hist_img_probs"][t] = e / e.sum()
        return out

    def ob_pano_arrays(self, rec: TrajRecord, t_cur: int) -> Dict[str, np.ndarray]:
        """Pano-layout observation at step t_cur: 36 views + STOP
        (r2r_data.py:204-220). Candidates marked nav type 1, STOP 2.
        Index mode ships the table row + view index; nav types and
        labels are identical in both modes."""
        g = self.graphs[rec.scan]
        vp = rec.path[t_cur]
        node = g.index(vp)
        vidx = int(rec.path_viewindex[t_cur])

        n = NUM_VIEWS + 1
        ob_nav = np.zeros((n,), np.int32)
        ob_nav[NUM_VIEWS] = 2
        cand_views = g.nbr_point_id[node][g.nbr_index[node] >= 0]
        ob_nav[cand_views] = 1

        if rec.action_viewindex[t_cur] != -1:
            gt_label = int(rec.action_viewindex[t_cur])
            gt_angle = standardize_radians(rec.rel_act_angles[t_cur])
        else:
            gt_label = NUM_VIEWS  # STOP token
            gt_angle = np.zeros((2,), np.float32)

        out = {
            "ob_nav": ob_nav,
            "ob_action_viewindex": np.int32(gt_label),
            "ob_action_angles": np.asarray(gt_angle, np.float32),
        }
        if self.feat_offsets is not None:
            out["ob_node"] = np.int32(self.feat_offsets[rec.scan] + node)
            out["ob_view"] = np.int32(vidx)
            return out
        fts = self._features(rec.scan, vp)
        ob_img = np.zeros((n, self.image_feat_size), np.float32)
        ob_img[:NUM_VIEWS] = fts[:, : self.image_feat_size]
        ob_ang = np.zeros((n, self.angle_feat_size), np.float32)
        ob_ang[:NUM_VIEWS] = self.angle_table[vidx]
        out.update(ob_img=ob_img, ob_ang=ob_ang,
                   ob_mask=np.ones((n,), bool))
        return out

    @property
    def ob_width(self) -> int:
        """Static observation token count for the configured layout."""
        return NUM_VIEWS + 1 + (self.ob_cand_extra
                                if self.ob_cand_pano_view else 0)

    def ob_arrays(self, rec: TrajRecord, t_cur: int) -> Dict[str, np.ndarray]:
        """Layout dispatch (r2r_data.py:180-188)."""
        if self.ob_cand_pano_view:
            return self.ob_cand_arrays(rec, t_cur)
        return self.ob_pano_arrays(rec, t_cur)

    def ob_cand_arrays(self, rec: TrajRecord, t_cur: int) -> Dict[str, np.ndarray]:
        """Candidate-first observation at step t_cur
        (``get_ob_cand_pano_view``, r2r_data.py:222-261): candidate
        views first — features from the candidate's discretized view,
        angle features from the EXACT edge angles relative to the
        current base heading — then a zero STOP token, then the
        non-candidate pano views. The SAP label is the candidate slot
        index (STOP = slot C). Candidate order follows the graph's
        neighbor tables where the reference follows its precomputed
        ``scanvp_cands`` JSON's key order — a per-viewpoint
        permutation of the same candidate set, with the label
        permuted consistently.

        Index mode ships ``ob_perm`` (slot -> source view, 36 = the
        zero row) + host-computed ``ob_ang``/``ob_nav``/``ob_mask``;
        the device expansion gathers features by the permutation.
        """
        g = self.graphs[rec.scan]
        vp = rec.path[t_cur]
        node = g.index(vp)
        vidx = int(rec.path_viewindex[t_cur])
        base_heading = float(view_heading(vidx))

        nbr_slots = np.nonzero(g.nbr_index[node] >= 0)[0]
        cand_pids = g.nbr_point_id[node, nbr_slots].astype(np.int64)
        n_cand = len(nbr_slots)
        # exact candidate angles rel. the base heading (the reference's
        # rel_angles[vidx][pid] + scanvp_cands offsets telescope to
        # exact_heading - base_heading, exact_elevation)
        cand_ang = angle_features(
            standardize_radians(g.nbr_heading[node, nbr_slots] - base_heading),
            g.nbr_elevation[node, nbr_slots], self.angle_feat_size,
        ).reshape(n_cand, self.angle_feat_size)

        non_cand = np.ones((NUM_VIEWS,), bool)
        non_cand[cand_pids] = False
        nc_views = np.nonzero(non_cand)[0]

        w = self.ob_width
        total = n_cand + 1 + len(nc_views)
        if total > w:
            raise ValueError(
                f"candidate-first layout needs {total} ob tokens at "
                f"{rec.scan}/{vp} (C={n_cand}, {len(nc_views)} non-cand) "
                f"but ob_cand_extra={self.ob_cand_extra} caps the width "
                f"at {w}; raise TrajectoryDataset(ob_cand_extra=...)")

        ob_nav = np.zeros((w,), np.int32)
        ob_nav[:n_cand] = 1
        ob_nav[n_cand] = 2
        ob_mask = np.zeros((w,), bool)
        ob_mask[:total] = True
        ob_ang = np.zeros((w, self.angle_feat_size), np.float32)
        ob_ang[:n_cand] = cand_ang
        ob_ang[n_cand + 1 : total] = self.angle_table[vidx][nc_views]

        # SAP gt: the slot of the candidate leading to path[t+1]
        # (r2r_data.py:233-235), STOP slot C otherwise (:258-260)
        gt_label = n_cand
        gt_angle = np.zeros((2,), np.float32)
        if (t_cur < len(rec.path) - 1
                and rec.action_viewindex[t_cur] != -1):
            nxt = g.index(rec.path[t_cur + 1])
            hits = np.nonzero(g.nbr_index[node, nbr_slots] == nxt)[0]
            if len(hits):
                gt_label = int(hits[0])
                gt_angle = standardize_radians(rec.rel_act_angles[t_cur])

        out = {
            "ob_nav": ob_nav,
            "ob_mask": ob_mask,
            "ob_ang": ob_ang,
            "ob_action_viewindex": np.int32(gt_label),
            "ob_action_angles": np.asarray(gt_angle, np.float32),
        }
        # slot -> source view permutation; 36 = the zero row (STOP/pad)
        perm = np.full((w,), NUM_VIEWS, np.int32)
        perm[:n_cand] = cand_pids
        perm[n_cand + 1 : total] = nc_views
        if self.feat_offsets is not None:
            out["ob_node"] = np.int32(self.feat_offsets[rec.scan] + node)
            out["ob_perm"] = perm
            return out
        fts = self._features(rec.scan, vp)[:, : self.image_feat_size]
        padded = np.concatenate(
            [fts, np.zeros((1, self.image_feat_size), fts.dtype)], axis=0)
        out["ob_img"] = padded[perm].astype(np.float32)
        return out

    def progress(self, rec: TrajRecord, t_cur: int) -> float:
        """Normalized progress label (r2r_data.py:337-345)."""
        g = self.graphs[rec.scan]
        start, cur, end = rec.path[0], rec.path[t_cur], rec.path[-1]
        if cur == end:
            return 1.0
        if start == cur:
            return 0.0
        total = float(g.dist[g.index(start), g.index(end)])
        remained = float(g.dist[g.index(cur), g.index(end)])
        return 1.0 - remained / max(total, 0.1)

    def txt_arrays(self, rec: TrajRecord, j_instr: int) -> Dict[str, np.ndarray]:
        enc = rec.instr_encodings[j_instr][: self.max_txt_len]
        ids = np.zeros((self.max_txt_len,), np.int32)
        mask = np.zeros((self.max_txt_len,), bool)
        ids[: len(enc)] = enc
        mask[: len(enc)] = True
        return {"txt_ids": ids, "txt_mask": mask}
