"""Fixed-shape batch builders for the six proxy tasks: a copy of
``vln_hamt_tpu/pretrain/tasks.py`` (numpy only) that draws the same
numpy random stream, so one seed gives the same batches in both
packages.

Parity target: the per-task ``Dataset``/collate pairs in
``pretrain_src/data/r2r_tasks.py`` — MLM (BERT 15% masking), MRC
(masked-history region classification), ITM (trajectory matching with
in-batch + shuffled-order negatives), SAP (action CE), SAR (action
angle + progress regression), SpRel (anchor-relative view angles).

Differences by design:
- every batch of a task has ONE static shape (padded to max_hist_len /
  max_txt_len / 37 ob tokens) instead of per-batch max padding;
- the MLM maskable vocab range is a parameter instead of the hardcoded
  bert-base range [1996, 29611] (r2r_tasks.py:60, a known defect);
- ITM negative indices / shuffles are sampled HERE and shipped in the
  batch, keeping the model's forward deterministic in its inputs.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..data.angle import DEG30
from .trajectory_data import IGNORE_ID, NUM_VIEWS, TrajectoryDataset, standardize_radians

TASK_NAMES = ("mlm", "mrc", "itm", "sap", "sar", "sprel")


def sprel_target_table() -> np.ndarray:
    """(36, 36, 2) anchor-relative (heading, elevation) in [-pi, pi)
    (r2r_tasks.py:498-506)."""
    views = np.arange(36)
    h = (views % 12) * DEG30
    e = (views // 12 - 1) * DEG30
    rel_h = standardize_radians(h[None, :] - h[:, None])
    rel_e = standardize_radians(e[None, :] - e[:, None])
    return np.stack([rel_h, rel_e], axis=-1).astype(np.float32)


class PretrainBatcher:
    def __init__(
        self,
        dataset: TrajectoryDataset,
        seed: int = 0,
        mask_token_id: int = 103,
        vocab_mask_range: Tuple[int, int] = (1996, 29611),
        mlm_prob: float = 0.15,
        mrc_mask_prob: float = 0.15,
        random_kill_v: float = 0.3,
        random_kill_a: float = 0.43,
        itm_in_batch_negs: int = 2,
        itm_shuffle_negs: int = 2,
    ):
        self.ds = dataset
        self.rng = np.random.default_rng(seed)
        self.mask_token_id = mask_token_id
        self.vocab_mask_range = vocab_mask_range
        self.mlm_prob = mlm_prob
        self.mrc_mask_prob = mrc_mask_prob
        self.random_kill_v = random_kill_v
        self.random_kill_a = random_kill_a
        self.itm_in_batch_negs = itm_in_batch_negs
        self.itm_shuffle_negs = itm_shuffle_negs
        self._sp_table = sprel_target_table()

    # ------------------------------------------------------------------
    def _stack(self, dicts: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        return {k: np.stack([d[k] for d in dicts]) for k in dicts[0]}

    def _traj_examples(self, batch_size: int, want_probs: bool = False,
                       refs=None):
        if refs is None:
            refs = [
                self.ds.traj_refer[self.rng.integers(len(self.ds.traj_refer))]
                for _ in range(batch_size)
            ]
        exs = []
        for (i, j, path_len) in refs:
            rec = self.ds.records[i]
            ex = {}
            ex.update(self.ds.txt_arrays(rec, j))
            ex.update(self.ds.history_arrays(rec, path_len, want_probs=want_probs))
            exs.append(ex)
        return exs

    def _step_examples(self, batch_size: int, want_ob: bool = True,
                       want_progress: bool = False, refs=None,
                       ob_layout: Optional[str] = None):
        """``ob_layout='pano'`` pins the pano layout regardless of the
        dataset flag — SpRel always uses it (r2r_tasks.py:514-517,
        ``ob_cand_pano_view=False``); SAP/SAR follow the dataset
        config (r2r_tasks.py:308-310, 401-403)."""
        if refs is None:
            refs = [
                self.ds.traj_step_refer[
                    self.rng.integers(len(self.ds.traj_step_refer))]
                for _ in range(batch_size)
            ]
        exs = []
        for (i, j, t) in refs:
            rec = self.ds.records[i]
            ex = {}
            ex.update(self.ds.txt_arrays(rec, j))
            ex.update(self.ds.history_arrays(rec, t))
            if want_ob:
                if ob_layout == "pano":
                    ex.update(self.ds.ob_pano_arrays(rec, t))
                else:
                    ex.update(self.ds.ob_arrays(rec, t))
                # random visual/angle kill regularizer (r2r_tasks.py:320-327).
                # Index mode ships the kill BITS (same rng draw order)
                # and the device expansion applies them.
                kill_v = self.rng.random() < self.random_kill_v
                kill_a = (not kill_v
                          and self.rng.random() < self.random_kill_a)
                if "ob_img" in ex:
                    if kill_v:
                        ex["ob_img"] = np.zeros_like(ex["ob_img"])
                    if kill_a:
                        ex["ob_ang"] = np.zeros_like(ex["ob_ang"])
                else:
                    ex["ob_kill_v"] = np.bool_(kill_v)
                    ex["ob_kill_a"] = np.bool_(kill_a)
            if want_progress:
                ex["ob_progress"] = np.float32(self.ds.progress(rec, t))
            exs.append(ex)
        return exs

    # ------------------------------------------------------------------
    def _mask_tokens(self, ids: np.ndarray, mask: np.ndarray):
        """BERT masking (r2r_tasks.py:12-53): 15% of real tokens; of
        those 80% -> [MASK], 10% -> random in-range, 10% unchanged."""
        out = ids.copy()
        labels = np.full_like(ids, IGNORE_ID)
        real = np.nonzero(mask)[0]
        probs = self.rng.random(len(real))
        chosen = real[probs < self.mlm_prob]
        if len(chosen) == 0:
            chosen = real[:1]
        labels[chosen] = ids[chosen]
        sub = self.rng.random(len(chosen))
        lo, hi = self.vocab_mask_range
        for c, s in zip(chosen, sub):
            if s < 0.8:
                out[c] = self.mask_token_id
            elif s < 0.9:
                out[c] = self.rng.integers(lo, hi)
        return out, labels

    # ------------------------------------------------------------------
    TRAJ_TASKS = ("mlm", "mrc", "itm")

    def n_examples(self, task: str) -> int:
        """Val-split size for the task's example granularity (the
        reference iterates the whole split per validator,
        main_r2r.py:319-511)."""
        return len(self.ds.traj_refer if task in self.TRAJ_TASKS
                   else self.ds.traj_step_refer)

    def ordered_refs(self, task: str, start: int, batch_size: int):
        """Fixed-order full-coverage refs [start, start+B) with
        wrap-around padding for the final partial batch (shapes stay
        static; the duplicated tail rows are deterministic)."""
        src = (self.ds.traj_refer if task in self.TRAJ_TASKS
               else self.ds.traj_step_refer)
        n = len(src)
        return [src[(start + i) % n] for i in range(batch_size)]

    def batch(self, task: str, batch_size: int,
              refs=None) -> Dict[str, np.ndarray]:
        if task == "mlm":
            exs = self._traj_examples(batch_size, refs=refs)
            b = self._stack(exs)
            ids, labels = zip(*[
                self._mask_tokens(b["txt_ids"][i], b["txt_mask"][i])
                for i in range(batch_size)
            ])
            b["txt_ids"] = np.stack(ids)
            b["txt_labels"] = np.stack(labels)
            return b

        if task == "mrc":
            exs = self._traj_examples(batch_size, want_probs=True, refs=refs)
            b = self._stack(exs)
            h = self.ds.max_hist_len
            mrc_masks = np.zeros((batch_size, h), bool)
            for i, ex in enumerate(exs):
                t = ex["hist_len"]
                m = self.rng.random(t) < self.mrc_mask_prob
                if t > 0 and not m.any():
                    m[self.rng.integers(t)] = True  # at least one
                mrc_masks[i, :t] = m
            # zero masked step features (input-side masking,
            # r2r_tasks.py:138-146); index mode defers the zeroing (and
            # the prob-label softmax) to the device expansion
            if "hist_img" in b:
                b["hist_img"] = np.where(mrc_masks[..., None], 0.0,
                                         b["hist_img"])
                if "hist_pano_img" in b:
                    b["hist_pano_img"] = np.where(
                        mrc_masks[..., None, None], 0.0, b["hist_pano_img"]
                    )
            b["hist_mrc_masks"] = mrc_masks
            return b

        if task == "itm":
            exs = self._traj_examples(batch_size, refs=refs)
            b = self._stack(exs)
            k1 = self.itm_in_batch_negs if batch_size > 1 else 0
            k2 = self.itm_shuffle_negs + (self.itm_in_batch_negs - k1)
            if k1 > 0:
                neg = np.zeros((batch_size, k1), np.int64)
                for i in range(batch_size):
                    pool = [x for x in range(batch_size) if x != i]
                    neg[i] = self.rng.choice(pool, k1, replace=len(pool) < k1)
                b["itm_neg_idxs"] = neg
            h = self.ds.max_hist_len
            shuf = np.zeros((k2, batch_size, h), np.int32)
            for k in range(k2):
                for i, ex in enumerate(exs):
                    t = ex["hist_len"]
                    perm = self.rng.permutation(t)
                    shuf[k, i] = np.concatenate([perm, np.arange(t, h)])
            b["itm_shuffled_pos"] = shuf
            return b

        if task == "sap":
            return self._stack(self._step_examples(batch_size, refs=refs))

        if task == "sar":
            return self._stack(self._step_examples(batch_size,
                                                   want_progress=True,
                                                   refs=refs))

        if task == "sprel":
            exs = self._step_examples(batch_size, refs=refs,
                                      ob_layout="pano")
            b = self._stack(exs)
            anchors = self.rng.integers(0, NUM_VIEWS, batch_size)
            b["sp_anchor_idxs"] = anchors.astype(np.int32)
            b["sp_targets"] = self._sp_table[anchors]
            return b

        raise ValueError(f"unknown task {task!r}")
