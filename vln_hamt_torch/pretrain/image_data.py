"""Raw panorama image data for end-to-end pretraining: a copy of
``vln_hamt_tpu/pretrain/image_data.py`` (numpy only) that draws the same
numpy random stream, so one seed gives the same batches in both packages.

Parity target: ``pretrain_src/data/image_data.py`` --
``MultiStepNavImageData`` reads (36, 248, 330, 3) uint8 panoramas from
LMDB keyed by ``{scan}_{viewpoint}`` (:20-22, 225-237). Here the store
is an interface: LMDB (``lmdb`` imported when such a store is opened), a
directory of ``.npy`` files, or deterministic synthetic images for
hermetic runs.

Batches mirror :class:`~vln_hamt_torch.pretrain.tasks.PretrainBatcher`
for all six image-mode tasks, swapping feature tensors for raw pixels +
per-step view indices (the model computes features with its in-loop
ViT): every task's batch holds ``hist_pano_images`` (B, T, 36, H, W, 3)
and ``hist_viewindex``; SAP, SAR and SpRel's hold ``ob_images`` (B, 36,
H, W, 3) too.

One deviation: the synthetic store seeds each panorama with
``zlib.crc32`` of its key, where the JAX package takes ``abs(hash())``,
which Python salts per process, so its synthetic images differ from run
to run; the port's are the same in every process.
"""

from __future__ import annotations

import os
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

from .tasks import PretrainBatcher
from .trajectory_data import NUM_VIEWS, TrajectoryDataset

DEFAULT_IMAGE_SIZE = (248, 330)  # reference LMDB record shape (:20-22)


class PanoImageStore:
    """get(scan, viewpoint) -> (36, H, W, 3) uint8."""

    image_size: Tuple[int, int]

    def get(self, scan: str, viewpoint: str) -> np.ndarray:
        raise NotImplementedError


class SyntheticPanoImageStore(PanoImageStore):
    def __init__(self, image_size: Tuple[int, int] = (32, 32)):
        self.image_size = image_size

    def get(self, scan: str, viewpoint: str) -> np.ndarray:
        # crc32, not hash(): str hashing is salted per process
        seed = zlib.crc32(f"img_{scan}_{viewpoint}".encode())
        rng = np.random.default_rng(seed)
        h, w = self.image_size
        return rng.integers(0, 255, (NUM_VIEWS, h, w, 3), dtype=np.uint8)


class LMDBPanoImageStore(PanoImageStore):
    """Reference LMDB format (image_data.py:225-237)."""

    def __init__(self, path: str, image_size: Tuple[int, int] = DEFAULT_IMAGE_SIZE):
        import lmdb  # optional dependency

        self.env = lmdb.open(path, readonly=True, lock=False)
        self.image_size = image_size

    def get(self, scan: str, viewpoint: str) -> np.ndarray:
        key = f"{scan}_{viewpoint}".encode("ascii")
        with self.env.begin() as txn:
            buf = txn.get(key)
        if buf is None:
            raise KeyError(f"no LMDB record for {scan}_{viewpoint}")
        h, w = self.image_size
        expected = NUM_VIEWS * h * w * 3
        if len(buf) != expected:
            raise ValueError(
                f"LMDB record {scan}_{viewpoint} holds {len(buf)} bytes but "
                f"image_size=({h}, {w}) implies (36, {h}, {w}, 3) = "
                f"{expected}; the reference store is (36, 248, 330, 3) "
                f"(image_data.py:20-22) — pass the store's true size and "
                f"let the ImageTransform produce the ViT input size")
        return np.frombuffer(buf, dtype=np.uint8).reshape(NUM_VIEWS, h, w, 3)


class NpyDirPanoImageStore(PanoImageStore):
    """{dir}/{scan}_{viewpoint}.npy with (36, H, W, 3) uint8 arrays."""

    def __init__(self, root: str, image_size: Tuple[int, int] = DEFAULT_IMAGE_SIZE):
        self.root = root
        self.image_size = image_size

    def get(self, scan: str, viewpoint: str) -> np.ndarray:
        return np.load(os.path.join(self.root, f"{scan}_{viewpoint}.npy"))


class ImagePretrainBatcher(PretrainBatcher):
    """Image-mode batches for all six proxy tasks.

    History supplies raw per-step panoramas + the faced view index;
    observations supply the current 36 raw views. Angle features stay
    precomputed (pure trig). The feature-space masking of MRC moves
    into the model (post-ViT), so here only the mask pattern ships.
    """

    def __init__(self, dataset: TrajectoryDataset, image_store: PanoImageStore,
                 transform=None, **kwargs):
        """``transform``: optional host-side uint8 image transform
        (vision.transforms.ImageTransform) applied to every store
        fetch — the reference applies the timm pipeline between LMDB
        and the ViT (image_data.py:70-80, 225-237); without it raw
        store-size pixels feed the ViT directly (hermetic tests)."""
        super().__init__(dataset, **kwargs)
        self.image_store = image_store
        self.transform = transform

    def _get_views(self, scan: str, viewpoint: str) -> np.ndarray:
        views = self.image_store.get(scan, viewpoint)
        if self.transform is not None:
            views = self.transform(views)
        return views

    def _attach_images(self, b: Dict[str, np.ndarray], refs, step_mode: bool):
        if self.transform is not None:
            h = w = self.transform.out_size
        else:
            h, w = self.image_store.image_size
        bs = len(refs)
        t_max = self.ds.max_hist_len
        pano = np.zeros((bs, t_max, NUM_VIEWS, h, w, 3), np.uint8)
        vidx = np.zeros((bs, t_max), np.int32)
        ob_imgs = np.zeros((bs, NUM_VIEWS, h, w, 3), np.uint8)
        for i, (i_traj, j_instr, t_cur) in enumerate(refs):
            rec = self.ds.records[i_traj]
            for t in range(min(t_cur, t_max)):
                pano[i, t] = self._get_views(rec.scan, rec.path[t])
                vidx[i, t] = rec.path_viewindex[t]
            if step_mode:
                ob_imgs[i] = self._get_views(rec.scan, rec.path[t_cur])
        b["hist_pano_images"] = pano
        b["hist_viewindex"] = vidx
        if step_mode:
            b["ob_images"] = ob_imgs
        # image-mode drops the precomputed feature tensors
        for k in ("hist_img", "hist_pano_img", "ob_img"):
            b.pop(k, None)
        return b

    STEP_TASKS = ("sap", "sar", "sprel")
    TRAJ_TASKS = ("mlm", "mrc", "itm")

    def batch(self, task: str, batch_size: int,
              refs=None) -> Dict[str, np.ndarray]:
        if task not in self.STEP_TASKS + self.TRAJ_TASKS:
            raise ValueError(f"unknown image-mode task {task!r}")
        # sample refs locally so we know which records were drawn
        # (explicit refs = deterministic full-split validation)
        if refs is None:
            if task in self.TRAJ_TASKS:
                refs = [self.ds.traj_refer[
                    self.rng.integers(len(self.ds.traj_refer))]
                    for _ in range(batch_size)]
            else:
                refs = [self.ds.traj_step_refer[
                    self.rng.integers(len(self.ds.traj_step_refer))]
                    for _ in range(batch_size)]

        exs = []
        for (i, j, t) in refs:
            rec = self.ds.records[i]
            ex = {}
            ex.update(self.ds.txt_arrays(rec, j))
            ex.update(self.ds.history_arrays(rec, t, want_probs=task == "mrc"))
            if task in self.STEP_TASKS:
                ex.update(self.ds.ob_pano_arrays(rec, t))
                if task == "sar":
                    ex["ob_progress"] = np.float32(self.ds.progress(rec, t))
            exs.append(ex)
        b = self._stack(exs)

        if task == "mlm":
            ids, labels = zip(*[
                self._mask_tokens(b["txt_ids"][i], b["txt_mask"][i])
                for i in range(batch_size)
            ])
            b["txt_ids"] = np.stack(ids)
            b["txt_labels"] = np.stack(labels)
        elif task == "mrc":
            t_max = self.ds.max_hist_len
            mrc = np.zeros((batch_size, t_max), bool)
            for i, ex in enumerate(exs):
                t = ex["hist_len"]
                m = self.rng.random(t) < self.mrc_mask_prob
                if t > 0 and not m.any():
                    m[self.rng.integers(t)] = True
                mrc[i, :t] = m
            b["hist_mrc_masks"] = mrc
        elif task == "itm":
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
        elif task in ("sap", "sar", "sprel"):
            # random visual kill becomes a scalar flag consumed post-ViT
            # (image_vilmodel.py ob_v_exists, :101-102)
            b["ob_v_exists"] = (
                self.rng.random(batch_size) >= self.random_kill_v
            ).astype(np.float32)
            if task == "sprel":
                from .tasks import sprel_target_table

                anchors = self.rng.integers(0, NUM_VIEWS, batch_size)
                b["sp_anchor_idxs"] = anchors.astype(np.int32)
                b["sp_targets"] = sprel_target_table()[anchors]

        return self._attach_images(b, refs, step_mode=task in self.STEP_TASKS)
