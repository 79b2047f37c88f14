"""Expert-trajectory preprocessing for pretraining: a copy of
``vln_hamt_tpu/run/build_trajectories.py``.

    python -m vln_hamt_torch.run.build_trajectories --anno_dir DIR \
        --connectivity_dir DIR --output train.jsonl [--dataset r2r] [--splits train]

The reference pretrains from trajectory JSONL with per-step view
indices, action view indices and relative action angles
(``pretrain_src/data/r2r_data.py:152-158``), produced by out-of-repo
scripts. This CLI derives those records directly from annotation files
plus connectivity graphs: the agent's discretized pose along the expert
path follows the closest-view rule, matching the runtime simulator.

Output: one JSON object per line with
  scan, path, path_viewindex, action_viewindex, rel_act_angles,
  instr_ids, instr_encodings
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from ..data.angle import view_heading
from ..data.instructions import load_instr_datasets
from ..data.nav_graph import load_nav_graphs
from ..env.sim import snap_heading_to_view
from ..pretrain.trajectory_data import standardize_radians


def derive_record(graph, item: dict) -> dict:
    path_idx = graph.indices(item["path"])
    t_len = len(path_idx)
    view_idx = np.zeros((t_len,), np.int32)
    act_view = np.full((t_len,), -1, np.int32)
    rel_ang = np.zeros((t_len, 2), np.float32)
    view_idx[0] = snap_heading_to_view(item.get("heading", 0.0))
    for t in range(t_len - 1):
        u, v = int(path_idx[t]), int(path_idx[t + 1])
        slots = np.nonzero(graph.nbr_index[u] == v)[0]
        assert len(slots), (
            f"{item.get('path_id')}: step {t} is not an edge {u}->{v}"
        )
        j = int(slots[0])
        pid = int(graph.nbr_point_id[u, j])
        act_view[t] = pid
        base_h = float(view_heading(view_idx[t]))
        rel_ang[t, 0] = standardize_radians(graph.nbr_heading[u, j] - base_h)
        rel_ang[t, 1] = graph.nbr_elevation[u, j]
        view_idx[t + 1] = pid
    return {
        "scan": item["scan"],
        "path": item["path"],
        "path_viewindex": view_idx.tolist(),
        "action_viewindex": act_view.tolist(),
        "rel_act_angles": rel_ang.tolist(),
        "instr_ids": [f"{item['path_id']}_{j}"
                      for j in range(len(item["instr_encodings"]))],
        "instr_encodings": item["instr_encodings"],
    }


def main(argv=None):
    p = argparse.ArgumentParser(description="build pretraining trajectories")
    p.add_argument("--anno_dir", required=True)
    p.add_argument("--dataset", default="r2r")
    p.add_argument("--splits", nargs="+", default=["train"])
    p.add_argument("--connectivity_dir", required=True)
    p.add_argument("--output", required=True)
    args = p.parse_args(argv)

    items = load_instr_datasets(args.anno_dir, args.dataset, args.splits)
    scans = sorted({x["scan"] for x in items})
    graphs = load_nav_graphs(args.connectivity_dir, scans)

    n = 0
    with open(args.output, "w") as f:
        for item in items:
            f.write(json.dumps(derive_record(graphs[item["scan"]], item)) + "\n")
            n += 1
    print(json.dumps({"trajectories": n, "scans": len(scans)}))


if __name__ == "__main__":
    main()
