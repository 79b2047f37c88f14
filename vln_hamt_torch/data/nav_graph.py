"""Navigation graphs as dense numpy arrays.

The reference stores graphs as networkx objects and dict-of-dict
all-pairs Dijkstra results (``finetune_src/r2r/env.py:131-147``), then
does per-sample dict lookups inside the rollout hot loop. Matterport
scans are small (tens to ~350 viewpoints), so we precompute *dense*
distance and next-hop matrices once per scan: every hot-path query
(teacher action, reward shaping distance, DTW cost rows, metric eval)
becomes vectorized numpy indexing, and the neighbor tables can be
shipped to the GPU for device-side graph transitions.

Connectivity JSON format parity: one ``{scan}_connectivity.json`` per
scan, entries with ``included``, ``unobstructed`` adjacency rows, 4x4
row-major ``pose`` with translation at indices 3/7/11, and ``image_id``
(``finetune_src/r2r/data_utils.py:86-111``).

The port of ``vln_hamt_tpu/data/nav_graph.py``: the tables come from
numpy or, with ``use_native`` (the default of the file loaders, as in
the JAX package), from the port's C++ core (``native/navsim.py``). The
two may break ``next_hop`` ties differently; the same choice as the JAX
package's gives the same teacher. Where the JAX package falls back to
numpy when its library cannot be built, the port raises.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List, Sequence

import numpy as np

from .angle import closest_view_index


class NavGraph:
    """One scan's navigation graph with precomputed dense tables.

    Attributes:
      node_ids: viewpointId strings, index order is the canonical node id.
      positions: (V, 3) float64 world positions.
      adj: (V, V) bool adjacency (undirected).
      dist: (V, V) float32 all-pairs shortest path lengths (euclidean
        edge weights), inf if unreachable.
      next_hop: (V, V) int32 successor matrix; ``next_hop[u, g]`` is the
        first node after ``u`` on a shortest path to ``g`` (-1 if
        unreachable, ``g`` itself when ``u == g``). Replaces the
        reference's stored full path lists.
      nbr_index / nbr_heading / nbr_elevation / nbr_point_id: (V, D)
        padded per-node neighbor tables (D = max degree), padded with -1
        index. Headings/elevations are absolute direction angles from the
        node to the neighbor; point_id is the closest of the 36 views.
    """

    def __init__(self, scan: str, node_ids: Sequence[str], positions: np.ndarray,
                 adj: np.ndarray, use_native: bool = False):
        self.scan = scan
        self.node_ids: List[str] = list(node_ids)
        self.node_index: Dict[str, int] = {v: i for i, v in enumerate(self.node_ids)}
        self.positions = np.asarray(positions, dtype=np.float64)
        self.adj = np.asarray(adj, dtype=bool)
        v = len(self.node_ids)
        assert self.positions.shape == (v, 3)
        assert self.adj.shape == (v, v)
        np.fill_diagonal(self.adj, False)
        assert (self.adj == self.adj.T).all(), "graph must be undirected"

        if use_native:
            self._build_native()
        else:
            self._build_shortest_paths()
            self._build_neighbor_tables()

    def _build_native(self) -> None:
        """The dense tables from the C++ core; raises when its library
        cannot be built."""
        from ..native import NativeNavGraph

        ng = NativeNavGraph(self.positions, self.adj)
        self.dist, self.next_hop, self.max_degree = ng.dist, ng.next_hop, ng.max_degree
        self.nbr_index, self.nbr_heading = ng.nbr_index, ng.nbr_heading
        self.nbr_elevation, self.nbr_point_id = ng.nbr_elevation, ng.nbr_point_id
        self.nbr_mask = self.nbr_index >= 0

    # ------------------------------------------------------------------
    @property
    def num_nodes(self) -> int:
        return len(self.node_ids)

    def index(self, viewpoint_id: str) -> int:
        return self.node_index[viewpoint_id]

    def indices(self, viewpoint_ids: Iterable[str]) -> np.ndarray:
        return np.array([self.node_index[v] for v in viewpoint_ids], dtype=np.int32)

    # ------------------------------------------------------------------
    def _build_shortest_paths(self) -> None:
        v = self.num_nodes
        delta = self.positions[:, None, :] - self.positions[None, :, :]
        euclid = np.sqrt((delta ** 2).sum(-1)).astype(np.float64)

        dist = np.full((v, v), np.inf, dtype=np.float64)
        np.fill_diagonal(dist, 0.0)
        dist[self.adj] = euclid[self.adj]

        nxt = np.full((v, v), -1, dtype=np.int32)
        ii, jj = np.nonzero(self.adj)
        nxt[ii, jj] = jj
        nxt[np.arange(v), np.arange(v)] = np.arange(v)

        # Vectorized Floyd–Warshall with successor tracking: O(V) numpy
        # passes of O(V^2) work each. V <= ~350 per Matterport scan.
        for k in range(v):
            via = dist[:, k, None] + dist[None, k, :]
            better = via < dist
            if better.any():
                dist = np.where(better, via, dist)
                nxt = np.where(better, nxt[:, k, None], nxt)

        self.dist = dist.astype(np.float32)
        self.next_hop = nxt

    def _build_neighbor_tables(self) -> None:
        v = self.num_nodes
        degrees = self.adj.sum(-1)
        max_deg = int(degrees.max()) if v else 0
        self.max_degree = max_deg

        nbr_index = np.full((v, max_deg), -1, dtype=np.int32)
        nbr_heading = np.zeros((v, max_deg), dtype=np.float32)
        nbr_elevation = np.zeros((v, max_deg), dtype=np.float32)
        for u in range(v):
            nbrs = np.nonzero(self.adj[u])[0]
            d = self.positions[nbrs] - self.positions[u]
            heading = np.arctan2(d[:, 0], d[:, 1])
            elevation = np.arctan2(d[:, 2], np.hypot(d[:, 0], d[:, 1]))
            nbr_index[u, : len(nbrs)] = nbrs
            nbr_heading[u, : len(nbrs)] = heading
            nbr_elevation[u, : len(nbrs)] = elevation
        self.nbr_index = nbr_index
        self.nbr_heading = nbr_heading
        self.nbr_elevation = nbr_elevation
        self.nbr_point_id = np.where(
            nbr_index >= 0, closest_view_index(nbr_heading, nbr_elevation), -1
        ).astype(np.int32)
        self.nbr_mask = nbr_index >= 0

    # ------------------------------------------------------------------
    def shortest_path(self, src: int, dst: int) -> List[int]:
        """Node-index path [src, ..., dst] via the successor matrix."""
        if self.next_hop[src, dst] < 0:
            raise ValueError(f"no path {src} -> {dst} in scan {self.scan}")
        path = [src]
        cur = src
        while cur != dst:
            cur = int(self.next_hop[cur, dst])
            path.append(cur)
        return path

    def path_length(self, path_idx: Sequence[int]) -> float:
        p = np.asarray(path_idx)
        if len(p) < 2:
            return 0.0
        return float(self.dist[p[:-1], p[1:]].sum())


# ----------------------------------------------------------------------
def _parse_connectivity(scan: str, raw: list, use_native: bool = False) -> NavGraph:
    included = [item["included"] for item in raw]
    ids = [item["image_id"] for item in raw]
    n = len(raw)
    adj_full = np.zeros((n, n), dtype=bool)
    pos_full = np.zeros((n, 3), dtype=np.float64)
    for i, item in enumerate(raw):
        pose = item["pose"]
        pos_full[i] = (pose[3], pose[7], pose[11])
        if not included[i]:
            continue
        for j, conn in enumerate(item["unobstructed"]):
            if conn and included[j]:
                adj_full[i, j] = True
    # the reference loader's graph is undirected (data_utils.py:107): a
    # one-sided edge is an error, not silently dropped
    if not (adj_full == adj_full.T).all():
        bad = np.argwhere(adj_full != adj_full.T)
        raise ValueError(f"scan {scan}: asymmetric connectivity at {bad[:4]}")
    # only included nodes (the reference adds edges between included
    # nodes only, so the others are isolated there)
    kept_idx = np.nonzero(np.array(included, dtype=bool))[0]
    return NavGraph(scan, [ids[i] for i in kept_idx], pos_full[kept_idx],
                    adj_full[np.ix_(kept_idx, kept_idx)], use_native=use_native)


def load_nav_graph(connectivity_dir: str, scan: str, use_native: bool = True) -> NavGraph:
    with open(os.path.join(connectivity_dir, f"{scan}_connectivity.json")) as f:
        return _parse_connectivity(scan, json.load(f), use_native)


def load_nav_graphs(connectivity_dir: str, scans: Iterable[str],
                    use_native: bool = True) -> Dict[str, NavGraph]:
    """One :class:`NavGraph` per scan from the reference's connectivity
    files (``finetune_src/r2r/data_utils.py:86-111``); the tables from
    the C++ core unless ``use_native`` is False."""
    return {scan: load_nav_graph(connectivity_dir, scan, use_native) for scan in scans}


def build_nav_tables(graphs: Dict[str, "NavGraph"], max_candidates: int):
    """Concatenate per-scan neighbor tables into global device tables.

    Scan order is sorted(graphs) — the SAME order as
    ``feature_db.build_feature_table`` so one scan->offset map serves
    both. Returns (tables, offsets) with tables:
      nbr_global (N, C) int32 — neighbor GLOBAL node id, -1 padded
      nbr_point  (N, C) int32 — neighbor's representative view index
      nbr_head   (N, C) f32   — absolute heading of the neighbor
      nbr_elev   (N, C) f32   — elevation of the neighbor

    These make the nav-graph transition a pure gather, so the greedy
    rollout (agents/rollout.py:build_device_rollout) walks the graph on
    the device — the replacement for the reference's per-step MatterSim
    calls (agent_cmt.py:213-246).
    """
    c = max_candidates
    offsets: Dict[str, int] = {}
    n_total = 0
    for scan in sorted(graphs):
        offsets[scan] = n_total
        n_total += graphs[scan].num_nodes
    nbr_global = np.full((n_total, c), -1, np.int32)
    nbr_point = np.zeros((n_total, c), np.int32)
    nbr_head = np.zeros((n_total, c), np.float32)
    nbr_elev = np.zeros((n_total, c), np.float32)
    for scan in sorted(graphs):
        g = graphs[scan]
        off = offsets[scan]
        deg = g.nbr_index.shape[1]
        if deg > c:
            raise ValueError(f"scan {scan} max degree {deg} > {c}")
        valid = g.nbr_index >= 0
        nbr_global[off:off + g.num_nodes, :deg] = np.where(
            valid, g.nbr_index + off, -1)
        nbr_point[off:off + g.num_nodes, :deg] = np.where(
            valid, g.nbr_point_id, 0)
        nbr_head[off:off + g.num_nodes, :deg] = np.where(
            valid, g.nbr_heading, 0.0)
        nbr_elev[off:off + g.num_nodes, :deg] = np.where(
            valid, g.nbr_elevation, 0.0)
    tables = {"nbr_global": nbr_global, "nbr_point": nbr_point,
              "nbr_head": nbr_head, "nbr_elev": nbr_elev}
    return tables, offsets
