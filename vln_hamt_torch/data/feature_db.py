"""Panorama image feature databases.

Reference: ``ImageFeaturesDB`` (``finetune_src/r2r/data_utils.py:9-23``)
reads HDF5 keyed ``{scan}_{viewpoint}`` -> (36, feat_dim) float32. The
port carries the deterministic synthetic DB (tests and hermetic runs)
and the feature-table builder of ``vln_hamt_tpu/data/feature_db.py``;
the HDF5 reader for real features is not part of the port yet (ROADMAP
item A12).
"""

from __future__ import annotations

import zlib
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
