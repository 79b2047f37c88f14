"""Hermetic synthetic worlds for tests and benchmarks.

The reference has no test fixtures at all (SURVEY §4); everything needs
Matterport scan data and the MatterSim binary. We generate deterministic
random navigation graphs + instruction data + features so the full
pipeline (env -> model -> agent -> metrics) runs anywhere. For the same
seed this builds the same world, and the same task-variant items and
object database, as ``vln_hamt_tpu/data/fixtures.py`` (tested).
:func:`export_real_format` writes a world as the reference's files.
"""

from __future__ import annotations

import dataclasses
import json
import os
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from .feature_db import SyntheticFeatureDB
from .nav_graph import NavGraph


@dataclasses.dataclass
class SyntheticWorld:
    graphs: Dict[str, NavGraph]
    instr_data: List[dict]
    feat_db: SyntheticFeatureDB

    @property
    def scans(self) -> List[str]:
        return sorted(self.graphs)


def make_synthetic_graph(
    scan: str,
    num_nodes: int = 24,
    rng: Optional[np.random.Generator] = None,
    extent: float = 18.0,
    z_extent: float = 2.5,
    connect_radius: float = 6.0,
    max_degree: int = 10,
) -> NavGraph:
    """A random geometric graph embedded in 3D, guaranteed connected.

    Nodes are sampled in an extent x extent x z_extent box; nodes within
    ``connect_radius`` are linked (bounded to ``max_degree``), then a
    chain over a random ordering guarantees connectivity. Mirrors the
    scale of Matterport scans (edges typically 1.5-4 m).
    """
    if rng is None:
        # crc32, not hash(): str hashing is salted per process
        rng = np.random.default_rng(zlib.crc32(scan.encode()))
    pos = np.empty((num_nodes, 3))
    pos[:, 0] = rng.uniform(0, extent, num_nodes)
    pos[:, 1] = rng.uniform(0, extent, num_nodes)
    pos[:, 2] = rng.uniform(0, z_extent, num_nodes)

    d = np.sqrt(((pos[:, None, :] - pos[None, :, :]) ** 2).sum(-1))
    adj = (d < connect_radius) & (d > 1e-6)

    # Bound the degree: keep the closest max_degree neighbors per node.
    for u in range(num_nodes):
        nbrs = np.nonzero(adj[u])[0]
        if len(nbrs) > max_degree:
            order = nbrs[np.argsort(d[u, nbrs])]
            drop = order[max_degree:]
            adj[u, drop] = False
            adj[drop, u] = False

    # Ensure connectivity with a chain over a random permutation.
    perm = rng.permutation(num_nodes)
    for a, b in zip(perm[:-1], perm[1:]):
        adj[a, b] = adj[b, a] = True

    node_ids = [f"{scan}_vp{i:04d}" for i in range(num_nodes)]
    return NavGraph(scan, node_ids, pos, adj | adj.T)


def make_synthetic_world(
    num_scans: int = 2,
    nodes_per_scan: int = 24,
    num_items: int = 32,
    path_hops: Tuple[int, int] = (4, 7),
    instr_len: Tuple[int, int] = (12, 40),
    vocab_size: int = 30522,
    feat_dim: int = 768,
    seed: int = 0,
) -> SyntheticWorld:
    rng = np.random.default_rng(seed)
    graphs = {
        f"scan{j:02d}": make_synthetic_graph(f"scan{j:02d}", nodes_per_scan, rng)
        for j in range(num_scans)
    }
    scans = sorted(graphs)

    instr_data: List[dict] = []
    for i in range(num_items):
        scan = scans[int(rng.integers(num_scans))]
        g = graphs[scan]
        hops = int(rng.integers(path_hops[0], path_hops[1] + 1))
        # sample a start; walk outward on shortest paths to a goal at
        # roughly `hops` graph distance
        start = int(rng.integers(g.num_nodes))
        # pick the goal whose shortest path has the desired hop count if
        # possible, otherwise the farthest reachable node
        path = None
        candidates = rng.permutation(g.num_nodes)
        for goal in candidates:
            goal = int(goal)
            if goal == start or not np.isfinite(g.dist[start, goal]):
                continue
            p = g.shortest_path(start, goal)
            if len(p) - 1 == hops:
                path = p
                break
            if path is None or len(p) > len(path):
                path = p
        assert path is not None and len(path) >= 2

        n_tok = int(rng.integers(instr_len[0], instr_len[1] + 1))
        # [CLS] body [SEP]; avoid special/pad ids in the body
        body = rng.integers(1000, min(vocab_size, 29000), n_tok - 2).tolist()
        enc = [101] + body + [102]
        heading = float(rng.integers(12)) * (np.pi / 6.0)
        instr_data.append(
            {
                "instr_id": f"{i}_0",
                "path_id": i,
                "scan": scan,
                "path": [g.node_ids[v] for v in path],
                "heading": heading,
                "instruction": " ".join(str(t) for t in body),
                "instr_encoding": enc,
            }
        )

    return SyntheticWorld(
        graphs=graphs,
        instr_data=instr_data,
        feat_db=SyntheticFeatureDB(feat_dim=feat_dim),
    )


# ----------------------------------------------------------------------
# Task-variant fixtures


def add_synthetic_objects(
    world: SyntheticWorld,
    objects_per_vp: int = 2,
    obj_feat_size: int = 768,
    seed: int = 0,
):
    """Synthesize a REVERIE-style object database.

    Returns (obj_db, obj2viewpoint) and rewrites the world's items with
    an ``objId`` visible from the path's last viewpoint. Object ids are
    strings as in BBoxes.json; each object is visible from its home
    viewpoint and that viewpoint's graph neighbors.
    """
    rng = np.random.default_rng(seed)
    obj_db: Dict[tuple, dict] = {}
    obj2viewpoint: Dict[str, List[str]] = {}
    for scan, g in world.graphs.items():
        for node in range(g.num_nodes):
            vp = g.node_ids[node]
            n = objects_per_vp
            obj_ids = [f"{node * 10 + k}" for k in range(n)]
            obj_db[(scan, vp)] = {
                "fts": rng.standard_normal((n, obj_feat_size)).astype(np.float32),
                "viewindexs": rng.integers(0, 36, n).astype(np.int64),
                "bboxes": np.stack(
                    [
                        rng.uniform(0, 600, n),
                        rng.uniform(0, 440, n),
                        rng.uniform(10, 40, n),
                        rng.uniform(10, 40, n),
                    ],
                    axis=1,
                ).astype(np.float32),
                "obj_ids": obj_ids,
            }
            visible_from = [vp] + [
                g.node_ids[int(x)] for x in g.nbr_index[node] if x >= 0
            ]
            for oid in obj_ids:
                obj2viewpoint[f"{scan}_{oid}"] = visible_from
    # annotate items with a target object at the goal viewpoint
    for item in world.instr_data:
        item["objId"] = obj_db[(item["scan"], item["path"][-1])]["obj_ids"][0]
        item["id"] = item["instr_id"]
    return obj_db, obj2viewpoint


def make_synthetic_cvdn_items(world: SyntheticWorld) -> List[dict]:
    """NDH-style items: start pano + multiple acceptable end panos."""
    items = []
    for item in world.instr_data:
        g = world.graphs[item["scan"]]
        goal = g.index(item["path"][-1])
        end_panos = [item["path"][-1]] + [
            g.node_ids[int(x)] for x in g.nbr_index[goal][:2] if x >= 0
        ]
        items.append(
            {
                "instr_id": item["instr_id"],
                "scan": item["scan"],
                "start_pano": item["path"][0],
                "start_heading": item["heading"],
                "end_panos": end_panos,
                "nav_steps": list(item["path"]),
                "nav_idx": 0,
                "instr_encoding": item["instr_encoding"],
            }
        )
    return items


def make_synthetic_r2rback_items(world: SyntheticWorld) -> List[dict]:
    """Return-to-start items: go out, midstop at the far end, come back."""
    items = []
    for item in world.instr_data:
        out = list(item["path"])
        back = list(reversed(out))[1:]
        items.append(
            {
                **item,
                "path": out + back,
                "midstop": out[-1],
            }
        )
    return items


# ----------------------------------------------------------------------
# Real-format export (runs of the file-backed path without Matterport data)


def export_nav_and_annotations(
    world: SyntheticWorld,
    dst_dir: str,
    splits: Optional[Dict[str, float]] = None,
) -> Dict[str, str]:
    """Write the world's graphs and items as the reference's JSON files:

    - ``connectivity/{scan}_connectivity.json``, the reference
      connectivity schema (``image_id`` / ``included`` / flat 4x4
      ``pose`` with the translation at [3], [7], [11] / ``unobstructed``
      in node order; the finetune_src/r2r/data_utils.py:86-111 reader),
      and ``connectivity/scans.txt``;
    - ``annotations/R2R_{split}_enc.json``, reference R2R annotation
      records (``path_id/scan/heading/path/instructions/instr_encodings``,
      which data_utils.py:56-83 expands per instruction).

    ``splits`` maps split name -> fraction of the items, in order;
    by default the three validation splits of the fine-tune CLI's
    ``build_real_dataset``. Returns ``{"connectivity_dir", "anno_dir"}``.
    """
    if splits is None:
        splits = {"val_train_seen": 0.2, "val_seen": 0.3, "val_unseen": 0.5}

    conn_dir = os.path.join(dst_dir, "connectivity")
    anno_dir = os.path.join(dst_dir, "annotations")
    os.makedirs(conn_dir, exist_ok=True)
    os.makedirs(anno_dir, exist_ok=True)

    for scan, g in world.graphs.items():
        entries = []
        for i, vp in enumerate(g.node_ids):
            pose = [0.0] * 16
            pose[0] = pose[5] = pose[10] = pose[15] = 1.0
            pose[3], pose[7], pose[11] = (float(x) for x in g.positions[i])
            entries.append({
                "image_id": vp,
                "included": True,
                "pose": pose,
                "height": 1.5,
                "unobstructed": [bool(g.adj[i, j]) for j in range(g.num_nodes)],
            })
        with open(os.path.join(conn_dir, f"{scan}_connectivity.json"), "w") as f:
            json.dump(entries, f)
    with open(os.path.join(conn_dir, "scans.txt"), "w") as f:
        f.write("\n".join(sorted(world.graphs)) + "\n")

    # regroup the per-instruction items into reference annotation
    # records (one record per path, instruction lists)
    items = list(world.instr_data)
    n = len(items)
    start = 0
    for split, frac in splits.items():
        stop = min(n, start + max(1, int(round(n * frac))))
        anno = []
        for it in items[start:stop]:
            g = world.graphs[it["scan"]]
            anno.append({
                "distance": float(g.dist[g.node_index[it["path"][0]],
                                         g.node_index[it["path"][-1]]]),
                "scan": it["scan"],
                "path_id": it["path_id"],
                "path": it["path"],
                "heading": it["heading"],
                "instructions": [it["instruction"]],
                "instr_encodings": [it["instr_encoding"]],
            })
        with open(os.path.join(anno_dir, f"R2R_{split}_enc.json"), "w") as f:
            json.dump(anno, f)
        start = stop
    return {"connectivity_dir": conn_dir, "anno_dir": anno_dir}


def export_real_format(
    world: SyntheticWorld,
    dst_dir: str,
    splits: Optional[Dict[str, float]] = None,
) -> Dict[str, str]:
    """:func:`export_nav_and_annotations`, plus ``features.hdf5``: one
    ``{scan}_{viewpoint}`` dataset of (36, feat_dim) float32 per viewpoint
    (the ``precompute_img_features_vit.py`` schema that
    ``HDF5FeatureDB`` reads). The files of
    ``vln_hamt_tpu/data/fixtures.py:export_real_format`` for the same
    world. Returns ``{"connectivity_dir", "anno_dir", "img_ft_file"}``.
    """
    import h5py

    out = export_nav_and_annotations(world, dst_dir, splits)
    ft_file = os.path.join(dst_dir, "features.hdf5")
    with h5py.File(ft_file, "w") as f:
        for scan, g in world.graphs.items():
            for vp in g.node_ids:
                f.create_dataset(f"{scan}_{vp}", data=world.feat_db.get(scan, vp))
    return {**out, "img_ft_file": ft_file}
