"""Panorama image feature databases.

Reference: ``ImageFeaturesDB`` (``finetune_src/r2r/data_utils.py:9-23``)
reads HDF5 keyed ``{scan}_{viewpoint}`` -> (36, feat_dim) float32 with an
unbounded in-RAM memo cache. The port carries, as
``vln_hamt_tpu/data/feature_db.py`` does, the HDF5 reader with the same
key scheme and a bounded LRU cache, the deterministic synthetic DB
(tests and hermetic runs) and the feature-table builder.
"""

from __future__ import annotations

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
