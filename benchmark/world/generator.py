"""The navigation world a cell runs in, made from the run's seed.

A frozen copy of ``vln_hamt_torch/data/fixtures.py:make_synthetic_world``
and ``make_synthetic_graph`` (random geometric graphs in a box, joined by
a chain so that every scan is connected; items that walk a shortest path
of a chosen number of hops), sized from the configuration and cell files
instead of the fixture's toy defaults, and vectorised where the copy
would loop over every item.

Nothing here imports the program: the world is the benchmark's input,
handed alike to the program and to the plain reference.

Sizes that shape the work are fixed by the files, never by the seed: the
number of scans, panoramas and items, the padded instruction length and
the candidate slots. The seed moves only positions, edges, paths and ids.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np


@dataclasses.dataclass
class Graph:
    """One scan: viewpoint ids, (V, 3) positions in metres, (V, V) adjacency."""

    scan: str
    node_ids: List[str]
    positions: np.ndarray
    adj: np.ndarray

    @property
    def num_nodes(self) -> int:
        return len(self.node_ids)


@dataclasses.dataclass
class World:
    graphs: Dict[str, Graph]
    items: List[dict]

    @property
    def scans(self) -> List[str]:
        return sorted(self.graphs)

    @property
    def num_nodes(self) -> int:
        return sum(g.num_nodes for g in self.graphs.values())


def make_graph(scan: str, num_nodes: int, rng: np.random.Generator, extent: float,
               z_extent: float, connect_radius: float, max_degree: int) -> Graph:
    """Nodes uniform in an extent x extent x z_extent box, linked within
    ``connect_radius`` and bounded to the ``max_degree`` nearest, then a
    chain over a random order (each node gains at most two edges)."""
    pos = np.empty((num_nodes, 3))
    pos[:, 0] = rng.uniform(0, extent, num_nodes)
    pos[:, 1] = rng.uniform(0, extent, num_nodes)
    pos[:, 2] = rng.uniform(0, z_extent, num_nodes)
    d = np.sqrt(((pos[:, None, :] - pos[None, :, :]) ** 2).sum(-1))
    adj = (d < connect_radius) & (d > 1e-6)
    for u in range(num_nodes):
        nbrs = np.nonzero(adj[u])[0]
        if len(nbrs) > max_degree:
            drop = nbrs[np.argsort(d[u, nbrs])][max_degree:]
            adj[u, drop] = False
            adj[drop, u] = False
    perm = rng.permutation(num_nodes)
    adj[perm[:-1], perm[1:]] = True
    adj[perm[1:], perm[:-1]] = True
    np.fill_diagonal(adj, False)
    node_ids = [f"{scan}_vp{i:04d}" for i in range(num_nodes)]
    return Graph(scan, node_ids, pos, adj)


def shortest_paths(g: Graph) -> Tuple[np.ndarray, np.ndarray]:
    """(dist, next_hop) by Floyd-Warshall over euclidean edge lengths, in
    float64; ``next_hop[u, v]`` is the first node after ``u`` on a
    shortest path to ``v`` (``v`` itself when ``u == v``)."""
    v = g.num_nodes
    delta = g.positions[:, None, :] - g.positions[None, :, :]
    euclid = np.sqrt((delta ** 2).sum(-1))
    dist = np.where(g.adj, euclid, np.inf)
    np.fill_diagonal(dist, 0.0)
    nxt = np.where(g.adj, np.arange(v)[None, :], -1)
    np.fill_diagonal(nxt, np.arange(v))
    for k in range(v):
        via = dist[:, k, None] + dist[None, k, :]
        better = via < dist
        if better.any():
            dist = np.where(better, via, dist)
            nxt = np.where(better, nxt[:, k, None], nxt)
    return dist, nxt


def hop_counts(nxt: np.ndarray) -> np.ndarray:
    """Edges on each shortest path of the ``next_hop`` table."""
    v = nxt.shape[0]
    hops = np.where(np.eye(v, dtype=bool), 0, v + 1)
    cols = np.arange(v)[None, :]
    for _ in range(v):
        new = np.where(np.eye(v, dtype=bool), 0, 1 + hops[nxt, cols])
        if (new == hops).all():
            break
        hops = new
    return hops


def make_world(spec: dict, split: dict, seed: int) -> World:
    """The world of one split.

    ``spec`` is the configuration's ``world`` group: ``extent_m``,
    ``z_extent_m``, ``connect_radius_m``, ``max_degree``, ``path_hops``
    [lo, hi], ``instr_tokens`` [lo, hi] (with [CLS] and [SEP]),
    ``token_ids`` [lo, hi), ``cls_id`` and ``sep_id``. ``split`` is the
    cell's ``world`` group: ``scans``, ``panoramas`` and ``items``.
    """
    rng = np.random.default_rng(seed)
    n_scans, n_pano, n_items = int(split["scans"]), int(split["panoramas"]), int(split["items"])
    base, extra = divmod(n_pano, n_scans)
    graphs, tables = {}, {}
    for j in range(n_scans):
        scan = f"scan{j:03d}"
        g = make_graph(scan, base + (j < extra), rng, spec["extent_m"], spec["z_extent_m"],
                       spec["connect_radius_m"], spec["max_degree"])
        graphs[scan] = g
        dist, nxt = shortest_paths(g)
        tables[scan] = (nxt, hop_counts(nxt))
    scans = sorted(graphs)
    lo, hi = spec["path_hops"]
    t_lo, t_hi = spec["instr_tokens"]
    id_lo, id_hi = spec["token_ids"]
    scan_of = rng.integers(n_scans, size=n_items)
    want = rng.integers(lo, hi + 1, size=n_items)
    n_tok = rng.integers(t_lo, t_hi + 1, size=n_items)
    headings = rng.integers(12, size=n_items) * (np.pi / 6.0)
    items = []
    for i in range(n_items):
        scan = scans[scan_of[i]]
        g = graphs[scan]
        nxt, hops = tables[scan]
        start = int(rng.integers(g.num_nodes))
        row = hops[start]
        goals = np.nonzero(row == want[i])[0]
        if len(goals) == 0:  # no node that far: the farthest in hops
            goals = np.nonzero(row == row[row <= g.num_nodes].max())[0]
        goal = int(goals[rng.integers(len(goals))])
        path = [start]
        while path[-1] != goal:
            path.append(int(nxt[path[-1], goal]))
        body = rng.integers(id_lo, id_hi, size=int(n_tok[i]) - 2).tolist()
        items.append({
            "instr_id": f"{i}_0", "path_id": i, "scan": scan,
            "path": [g.node_ids[v] for v in path], "heading": float(headings[i]),
            "instr_encoding": [int(spec["cls_id"])] + body + [int(spec["sep_id"])],
        })
    return World(graphs, items)


def max_degree(world: World) -> int:
    return max(int(g.adj.sum(-1).max()) for g in world.graphs.values())
