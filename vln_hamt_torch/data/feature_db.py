"""Panorama image feature databases.

Reference: ``ImageFeaturesDB`` (``finetune_src/r2r/data_utils.py:9-23``)
reads HDF5 keyed ``{scan}_{viewpoint}`` -> (36, feat_dim) float32 with an
unbounded in-RAM memo cache. The port carries, as
``vln_hamt_tpu/data/feature_db.py`` does, the HDF5 reader with the same
key scheme and a bounded LRU cache, the deterministic synthetic DB
(tests and hermetic runs), the feature-table builder, and REVERIE's
object loaders and node-aligned object table.
"""

from __future__ import annotations

import json
import os
import zlib
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import numpy as np

NUM_VIEWS = 36


class FeatureDB:
    """get(scan, viewpoint) -> (36, feat_dim) float32."""

    feat_dim: int

    def get(self, scan: str, viewpoint: str) -> np.ndarray:
        raise NotImplementedError

    # Reference-compatible alias (data_utils.py:15)
    def get_image_feature(self, scan: str, viewpoint: str) -> np.ndarray:
        return self.get(scan, viewpoint)


class HDF5FeatureDB(FeatureDB):
    """HDF5-backed features with a bounded LRU cache.

    The reference reopens the file per miss (data_utils.py:20); this
    keeps one handle open and bounds the cache instead of growing it
    forever; :meth:`close` closes it. ``h5py`` is imported here, not
    with the module.
    """

    def __init__(self, path: str, feat_dim: int, cache_items: int = 20_000):
        import h5py

        self.path = path
        self.feat_dim = feat_dim
        self._file = h5py.File(path, "r")
        self._cache: "OrderedDict[str, np.ndarray]" = OrderedDict()
        self._cache_items = cache_items

    def get(self, scan: str, viewpoint: str) -> np.ndarray:
        key = f"{scan}_{viewpoint}"
        ft = self._cache.get(key)
        if ft is None:
            ft = self._file[key][...][:, : self.feat_dim].astype(np.float32)
            self._cache[key] = ft
            if len(self._cache) > self._cache_items:
                self._cache.popitem(last=False)
        else:
            self._cache.move_to_end(key)
        return ft

    def close(self) -> None:
        self._file.close()


class SyntheticFeatureDB(FeatureDB):
    """Deterministic pseudo-random features keyed by (scan, viewpoint).

    Used by the hermetic test/bench worlds. Features are a pure function
    of the key and shape, stable across processes.
    """

    def __init__(self, feat_dim: int = 768, scale: float = 1.0, cache: bool = True):
        self.feat_dim = feat_dim
        self.scale = scale
        self._cache: Optional[Dict[Tuple[str, str], np.ndarray]] = {} if cache else None

    def get(self, scan: str, viewpoint: str) -> np.ndarray:
        key = (scan, viewpoint)
        if self._cache is not None and key in self._cache:
            return self._cache[key]
        # zlib.crc32, NOT hash(): str hashing is salted per process
        # (PYTHONHASHSEED), which would give every process of a run
        # different "deterministic" features
        seed = zlib.crc32(f"{scan}_{viewpoint}".encode())
        rng = np.random.default_rng(seed)
        ft = rng.standard_normal((NUM_VIEWS, self.feat_dim), dtype=np.float32) * self.scale
        if self._cache is not None:
            self._cache[key] = ft
        return ft


def load_object_db(obj_ft_file: str, obj_feat_size: int) -> Dict[Tuple[str, str], dict]:
    """REVERIE object-feature HDF5 -> {(scan, viewpoint): entry}.

    Reference: ``load_obj_database`` (reverie/data_utils.py:33-43) —
    one dataset per ``{scan}_{viewpoint}`` key with ``obj_ids``,
    ``bboxes`` (xywh) and ``viewindexs`` attrs; features clipped to
    ``obj_feat_size``; keyed by tuple (the env's ``obj_db`` schema).
    ``h5py`` is imported here, not with the module.
    """
    import h5py

    out: Dict[Tuple[str, str], dict] = {}
    with h5py.File(obj_ft_file, "r") as f:
        for key in f:
            scan, vp = key.split("_", 1)  # scan ids hold no "_"
            out[(scan, vp)] = {
                "obj_ids": [str(x) for x in f[key].attrs["obj_ids"]],
                "fts": f[key][...].astype(np.float32)[:, :obj_feat_size],
                "bboxes": np.asarray(f[key].attrs["bboxes"]),
                "viewindexs": np.asarray(f[key].attrs["viewindexs"]),
            }
    return out


def load_obj2viewpoint(anno_dir: str) -> Dict[str, list]:
    """``BBoxes.json`` -> {f"{scan}_{objid}": [viewpoints where visible]}.

    Reference: ``ReverieNavRefBatch.__init__``
    (reverie/env.py:149-159): an object is attributed to every
    viewpoint whose bbox entry has a non-empty ``visible_pos``.
    """
    with open(os.path.join(anno_dir, "BBoxes.json")) as f:
        bbox_data = json.load(f)
    obj2vp: Dict[str, list] = {}
    for scanvp, value in bbox_data.items():
        scan, vp = scanvp.split("_", 1)
        for objid, objinfo in value.items():
            if objinfo["visible_pos"]:
                obj2vp.setdefault(f"{scan}_{objid}", []).append(vp)
    return obj2vp


def build_feature_table(graphs, feat_db) -> Tuple[np.ndarray, Dict[str, int]]:
    """Materialize the whole split's pano features as one (N, V, D)
    table plus scan -> row-offset map.

    The agent moves this table to the device ONCE and the greedy
    rollout gathers each step's (B, V, D) panoramas from it by global
    node index, so no features cross the host-device link per step.
    Replaces the reference's per-obs host feature assembly
    (``finetune_src/r2r/env.py:270-303``).
    """
    offsets: Dict[str, int] = {}
    rows = []
    n = 0
    for scan in sorted(graphs):
        g = graphs[scan]
        offsets[scan] = n
        for vid in g.node_ids:
            rows.append(feat_db.get(scan, vid))
        n += g.num_nodes
    return np.stack(rows), offsets


def build_object_table(graphs, obj_db, max_objects: int, obj_feat_size: int,
                       obj_local_pos) -> Tuple[Dict[str, np.ndarray],
                                               Dict[str, int]]:
    """Device-resident REVERIE object tables in the feature-table layout.

    Same sorted-scan row layout (and therefore the same offsets) as
    :func:`build_feature_table`, so one ``(B, T)`` node-index stream
    addresses BOTH tables. Per global node row: padded object features,
    view indexes, normalized bbox positions and a validity mask —
    everything the obs assembly gathered per step on the host
    (``env/task_envs.py:ReverieNavEnv._observe``) except the relative
    object angles, which depend on the agent's current view and are
    computed on device from the (36, 36, A) angle table.

    ``obj_local_pos``: bbox (K, 4) xywh -> (K, 5) normalized, i.e.
    ``ReverieNavEnv._obj_local_pos`` (reverie/data_utils.py:31-43).
    """
    offsets: Dict[str, int] = {}
    n = sum(g.num_nodes for g in graphs.values())
    k = max_objects
    fts = np.zeros((n, k, obj_feat_size), np.float32)
    view = np.zeros((n, k), np.int32)
    pos = np.zeros((n, k, 5), np.float32)
    mask = np.zeros((n, k), bool)
    row = 0
    for scan in sorted(graphs):
        g = graphs[scan]
        offsets[scan] = row
        for vid in g.node_ids:
            entry = obj_db.get((scan, vid))
            if entry is not None:
                m = min(len(entry["obj_ids"]), k)
                fts[row, :m] = entry["fts"][:m]
                view[row, :m] = np.asarray(entry["viewindexs"][:m], np.int32)
                pos[row, :m] = obj_local_pos(entry["bboxes"][:m])
                mask[row, :m] = True
            row += 1
    return {"fts": fts, "view": view, "pos": pos, "mask": mask}, offsets
