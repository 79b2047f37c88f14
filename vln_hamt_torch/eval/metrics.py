"""VLN trajectory metrics over dense distance matrices.

Parity targets: ``finetune_src/r2r/eval_utils.py:74-110`` (DTW / nDTW /
SDTW / CLS) and ``finetune_src/r2r/env.py:332-386`` (_eval_item /
eval_metrics). The reference computes DTW with dict-of-dict distance
lookups per cell; here paths are node-index arrays and distances come
from the scan's dense ``NavGraph.dist`` matrix, so cost matrices are a
single fancy-index and the DP runs on numpy rows. RL reward shaping
(``agent_cmt.py:407-445`` calls cal_dtw per sample per step) uses
:class:`IncrementalNDTW` on the host path and an in-scan DP row
extension on the device rollout (``agents/rollout.py:_dp_extend``).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

ERROR_MARGIN = 3.0


def dtw_scores(
    dist: np.ndarray,
    prediction: Sequence[int],
    reference: Sequence[int],
    success: float | None = None,
    threshold: float = ERROR_MARGIN,
) -> Dict[str, float]:
    """DTW / nDTW / SDTW of an index path vs reference (eval_utils.py:74-94)."""
    pred = np.asarray(prediction, dtype=np.int64)
    ref = np.asarray(reference, dtype=np.int64)
    cost = dist[np.ix_(pred, ref)].astype(np.float64)  # (P, R)

    prev = np.full(len(ref) + 1, np.inf)
    prev[0] = 0.0
    for i in range(len(pred)):
        cur = np.full(len(ref) + 1, np.inf)
        for j in range(1, len(ref) + 1):
            cur[j] = cost[i, j - 1] + min(prev[j], prev[j - 1], cur[j - 1])
        prev = cur

    dtw = float(prev[len(ref)])
    ndtw = float(np.exp(-dtw / (threshold * len(ref))))
    if success is None:
        success = float(dist[pred[-1], ref[-1]] < threshold)
    return {"DTW": dtw, "nDTW": ndtw, "SDTW": float(success) * ndtw}


class IncrementalNDTW:
    """Per-sample nDTW of a growing prediction path, O(R) per step.

    The reference recomputes the full O(P*R) DTW table per sample per RL
    step (``agent_cmt.py:289,416``). The DTW DP only ever consumes one
    new prediction row, so we keep the last DP row per sample and extend
    it — same value, ~P times cheaper, and no per-step Python DP loops.
    """

    def __init__(self, dists: List[np.ndarray], refs: List[Sequence[int]],
                 starts: Sequence[int], threshold: float = ERROR_MARGIN):
        self.dists = dists
        self.refs = [np.asarray(r, dtype=np.int64) for r in refs]
        self.threshold = threshold
        self.rows = []
        for i, start in enumerate(starts):
            row = np.full(len(self.refs[i]) + 1, np.inf)
            row[0] = 0.0
            self.rows.append(row)
            self._extend(i, int(start))

    def _extend(self, i: int, node: int) -> None:
        ref = self.refs[i]
        prev = self.rows[i]
        cost = self.dists[i][node, ref]
        cur = np.full_like(prev, np.inf)
        for j in range(1, len(ref) + 1):
            cur[j] = cost[j - 1] + min(prev[j], prev[j - 1], cur[j - 1])
        cur[0] = np.inf  # the first prediction row closes column 0
        self.rows[i] = cur

    def update(self, i: int, node: int) -> None:
        """Append one node to sample i's prediction path."""
        self._extend(i, int(node))

    def value(self, i: int) -> float:
        ref_len = len(self.refs[i])
        return float(np.exp(-self.rows[i][ref_len] / (self.threshold * ref_len)))


def cls_score(
    dist: np.ndarray,
    prediction: Sequence[int],
    reference: Sequence[int],
    threshold: float = ERROR_MARGIN,
) -> float:
    """Coverage-weighted Length Score (eval_utils.py:96-110)."""
    pred = np.asarray(prediction, dtype=np.int64)
    ref = np.asarray(reference, dtype=np.int64)

    def length(nodes: np.ndarray) -> float:
        if len(nodes) < 2:
            return 0.0
        return float(dist[nodes[:-1], nodes[1:]].sum())

    coverage = float(np.mean(np.exp(-dist[np.ix_(ref, pred)].min(axis=1) / threshold)))
    expected = coverage * length(ref)
    score = expected / (expected + abs(expected - length(pred))) if expected > 0 else 0.0
    return coverage * score


def eval_r2r_item(
    dist: np.ndarray,
    path: Sequence[int],
    gt_path: Sequence[int],
    error_margin: float = ERROR_MARGIN,
) -> Dict[str, float]:
    """Single-trajectory R2R metric suite (env.py:332-357)."""
    path = np.asarray(path, dtype=np.int64)
    gt = np.asarray(gt_path, dtype=np.int64)
    assert path[0] == gt[0], "Result trajectories should include the start position"

    goal = gt[-1]
    to_goal = dist[path, goal]
    scores: Dict[str, float] = {}
    scores["nav_error"] = float(dist[path[-1], goal])
    scores["oracle_error"] = float(to_goal.min())
    scores["trajectory_steps"] = float(len(path) - 1)
    scores["trajectory_lengths"] = float(dist[path[:-1], path[1:]].sum()) if len(path) > 1 else 0.0
    gt_lengths = float(dist[gt[:-1], gt[1:]].sum()) if len(gt) > 1 else 0.0

    scores["success"] = float(scores["nav_error"] < error_margin)
    scores["spl"] = (
        scores["success"] * gt_lengths / max(scores["trajectory_lengths"], gt_lengths, 0.01)
    )
    scores["oracle_success"] = float(scores["oracle_error"] < error_margin)
    scores.update(dtw_scores(dist, path, gt, scores["success"], error_margin))
    scores["CLS"] = cls_score(dist, path, gt, error_margin)
    return scores


def aggregate_metrics(per_item: List[Dict[str, float]]) -> Dict[str, float]:
    """Average metric dict (env.py:374-385 naming/scaling)."""

    def m(key: str) -> float:
        return float(np.mean([s[key] for s in per_item])) if per_item else 0.0

    return {
        "steps": m("trajectory_steps"),
        "lengths": m("trajectory_lengths"),
        "nav_error": m("nav_error"),
        "oracle_error": m("oracle_error"),
        "sr": m("success") * 100,
        "oracle_sr": m("oracle_success") * 100,
        "spl": m("spl") * 100,
        "nDTW": m("nDTW") * 100,
        "SDTW": m("SDTW") * 100,
        "CLS": m("CLS") * 100,
    }
