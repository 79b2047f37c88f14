"""The task variants' file-backed path end to end on the CPU against the
JAX package: a fixture world written as the reference's files (the
connectivity, R2R-Back's ``ReturnBack/R2R_{split}_enc.json`` with its
midstops, CVDN's ``{split}_enc.json`` dialog items with their end panos,
REVERIE's ``REVERIE_{split}_enc.json`` with target objects,
``BBoxes.json`` and an object-feature HDF5 file), then
``finetune.main(["--valid_only", "--tiny", "--cpu", "--init_ref_ckpt",
...])`` of both packages: the same metrics within 1e-6 and the same
predictions (midstops, predicted objects) in the submission files. Set-up
from tests/test_torch_cli_files.py."""

import json
import os

import numpy as np
import pytest
import torch

from test_torch_checkpoints import write_agent_ckpt
from test_torch_cli_files import METRIC_ATOL, TINY_MODEL, jax_main
from test_torch_train import train_test_setup  # noqa: F401 (autouse fixture)
from vln_hamt_torch.configs import get_preset
from vln_hamt_torch.data.fixtures import (add_synthetic_objects, export_real_format,
                                          make_synthetic_world)
from vln_hamt_torch.models.hamt import init_hamt
from vln_hamt_torch.run import finetune

SPLITS = ("val_train_seen", "val_seen", "val_unseen")


def world_without_underscores():
    """A fixture world whose viewpoint ids, like Matterport's, hold no
    "_" (the reference's ``{scan}_{viewpoint}`` keys split on it)."""
    world = make_synthetic_world(num_scans=2, nodes_per_scan=16, num_items=20, feat_dim=32,
                                 seed=4)
    for g in world.graphs.values():
        g.node_ids = [v.replace("_", "") for v in g.node_ids]
        g.node_index = {v: i for i, v in enumerate(g.node_ids)}
    for it in world.instr_data:
        it["path"] = [v.replace("_", "") for v in it["path"]]
    return world


def write_task_files(world, task, root):
    """The reference's files of ``task`` for the world's items (the R2R
    annotation records of export_real_format, rewritten)."""
    files = export_real_format(world, str(root))
    anno = files["anno_dir"]
    extra = []
    if task == "reverie":
        obj_db, _ = add_synthetic_objects(world, obj_feat_size=32, seed=1)
        goal_obj = {it["path_id"]: it["objId"] for it in world.instr_data}
    for split in SPLITS:
        with open(os.path.join(anno, f"R2R_{split}_enc.json")) as f:
            records = json.load(f)
        if task == "r2r_back":
            os.makedirs(os.path.join(anno, "ReturnBack"), exist_ok=True)
            out = [{**r, "path": r["path"] + r["path"][-2::-1], "midstop": r["path"][-1]}
                   for r in records]
            name = os.path.join("ReturnBack", f"R2R_{split}_enc.json")
        elif task == "reverie":
            out = [{**r, "objId": goal_obj[r["path_id"]], "id": str(r["path_id"])}
                   for r in records]
            name = f"REVERIE_{split}_enc.json"
        else:
            out = []
            for r in records:
                g = world.graphs[r["scan"]]
                goal = g.index(r["path"][-1])
                out.append({"instr_id": f"{r['path_id']}_0", "scan": r["scan"],
                            "start_pano": r["path"][0], "start_heading": r["heading"],
                            "end_panos": [r["path"][-1]] + [g.node_ids[int(x)] for x in
                                                            g.nbr_index[goal][:2] if x >= 0],
                            "nav_steps": r["path"], "nav_idx": 0,
                            "instr_encoding": r["instr_encodings"][0]})
            name = f"{split}_enc.json"
        with open(os.path.join(anno, name), "w") as f:
            json.dump(out, f)
    if task == "reverie":
        import h5py

        bbox = {}
        with h5py.File(os.path.join(str(root), "obj.hdf5"), "w") as f:
            for (scan, vp), e in obj_db.items():
                ds = f.create_dataset(f"{scan}_{vp}", data=e["fts"])
                ds.attrs["obj_ids"] = e["obj_ids"]
                ds.attrs["bboxes"] = e["bboxes"]
                ds.attrs["viewindexs"] = e["viewindexs"]
                bbox[f"{scan}_{vp}"] = {oid: {"visible_pos": [1]} for oid in e["obj_ids"]}
        # an object is seen from its home viewpoint and its neighbours
        for scan, g in world.graphs.items():
            for node, vp in enumerate(g.node_ids):
                for nb in g.nbr_index[node]:
                    if nb >= 0:
                        for oid in obj_db[(scan, vp)]["obj_ids"]:
                            bbox[f"{scan}_{g.node_ids[int(nb)]}"][oid] = {"visible_pos": [2]}
        with open(os.path.join(anno, "BBoxes.json"), "w") as f:
            json.dump(bbox, f)
        extra = ["--obj_ft_file", os.path.join(str(root), "obj.hdf5")]
    return ["--anno_dir", anno, "--connectivity_dir", files["connectivity_dir"],
            "--img_ft_file", files["img_ft_file"]] + extra


def reference_checkpoint(task, path, seed=11):
    """An agent-format reference checkpoint of the task's --tiny model
    (REVERIE's with its 32-d object embeddings and head: a NavRefModel
    save), from a seeded port model with non-trivial LayerNorm terms."""
    model = dict(TINY_MODEL, **({"obj_feat_size": 32} if task == "reverie" else {}))
    net, critic = init_hamt(get_preset(task).replace(model=model).model, seed=seed)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in net.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    write_agent_ckpt(path, net, critic)
    return path


@pytest.mark.parametrize("task", ["r2r_back", "cvdn", "reverie"])
def test_file_backed_valid_only_matches_jax(tmp_path, capsys, task):
    data = write_task_files(world_without_underscores(), task, tmp_path / "data")
    ckpt = reference_checkpoint(task, str(tmp_path / "ref.pt"))
    argv = ["--task", task, "--valid_only", "--tiny", "--cpu", "--init_ref_ckpt", ckpt] + data
    want = jax_main(argv + ["--output_dir", str(tmp_path / "jax"), "--submit"], capsys)["valid"]
    got = finetune.main(argv + ["--output_dir", str(tmp_path / "port"), "--submit"])
    assert set(got) == set(want) == set(SPLITS)
    for split in want:
        assert got[split].keys() == want[split].keys()
        for k in want[split]:
            assert abs(got[split][k] - want[split][k]) <= METRIC_ATOL, (split, k)
    extra = {"r2r_back": "midstop", "reverie": "predObjId"}.get(task)
    for split in SPLITS:
        jt = json.loads((tmp_path / "jax" / f"submit_{split}.json").read_text())
        pt = json.loads((tmp_path / "port" / f"submit_{split}.json").read_text())
        assert [p["instr_id"] for p in pt] == [p["instr_id"] for p in jt] and pt
        for p, j in zip(pt, jt):
            assert [v for v, _, _ in p["trajectory"]] == [v for v, _, _ in j["trajectory"]]
            np.testing.assert_allclose(np.array([t[1:] for t in p["trajectory"]]),
                                       np.array([t[1:] for t in j["trajectory"]]), atol=1e-6)
            if extra:
                assert p[extra] == j[extra]
    assert "skipped" not in (tmp_path / "port" / "valid.txt").read_text()
