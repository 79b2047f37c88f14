"""The port's file-backed data path against the JAX package: the
reference-format export of a fixture world, the connectivity loader, the
annotation loaders of the R2R family (r2r, r2r_last, r4r, rxr and an aug
path, from files written here) and the HDF5 feature reader."""

import json
import os

import h5py
import numpy as np
import pytest

from vln_hamt_tpu.data import instructions as jinstr
from vln_hamt_tpu.data.feature_db import HDF5FeatureDB as JaxHDF5FeatureDB
from vln_hamt_tpu.data.fixtures import export_real_format as jax_export
from vln_hamt_tpu.data.fixtures import make_synthetic_world as jax_world
from vln_hamt_tpu.data.nav_graph import load_nav_graphs as jax_load_nav_graphs
from vln_hamt_torch.data import instructions as tinstr
from vln_hamt_torch.data.feature_db import HDF5FeatureDB
from vln_hamt_torch.data.fixtures import (export_nav_and_annotations, export_real_format,
                                          make_synthetic_world)
from vln_hamt_torch.data.nav_graph import load_nav_graph, load_nav_graphs

WORLD = dict(num_scans=2, nodes_per_scan=14, num_items=10, feat_dim=16, seed=3)
SPLITS = {"train": 0.4, "val_seen": 0.3, "val_unseen": 0.3}


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """The same world exported by both packages."""
    root = tmp_path_factory.mktemp("export")
    jax_files = jax_export(jax_world(**WORLD), str(root / "jax"), SPLITS)
    port_files = export_real_format(make_synthetic_world(**WORLD), str(root / "port"), SPLITS)
    return jax_files, port_files


def _tree(d):
    return sorted(os.path.relpath(os.path.join(r, f), d)
                  for r, _, fs in os.walk(d) for f in fs)


def test_export_writes_the_jax_files(exported):
    """The same JSON and the same HDF5 arrays, file for file."""
    jax_files, port_files = exported
    for key in ("connectivity_dir", "anno_dir"):
        names = _tree(port_files[key])
        assert names == _tree(jax_files[key]) and len(names) > 2
        for name in names:
            with open(os.path.join(port_files[key], name)) as f:
                got = f.read()
            with open(os.path.join(jax_files[key], name)) as f:
                want = f.read()
            assert (json.loads(got) == json.loads(want)) if name.endswith(".json") \
                else got == want, name
    with h5py.File(port_files["img_ft_file"]) as got, h5py.File(jax_files["img_ft_file"]) as want:
        assert sorted(got) == sorted(want) and len(got) == 2 * WORLD["nodes_per_scan"]
        for key in want:
            assert got[key].dtype == np.float32
            np.testing.assert_array_equal(got[key][...], want[key][...], err_msg=key)
    # the export without features writes the same JSON and no HDF5 file
    out = export_nav_and_annotations(make_synthetic_world(**WORLD),
                                     os.path.join(os.path.dirname(port_files["anno_dir"]),
                                                  "..", "json_only"), SPLITS)
    assert _tree(out["anno_dir"]) == _tree(port_files["anno_dir"])
    assert not os.path.exists(os.path.join(out["anno_dir"], "..", "features.hdf5"))


def test_load_nav_graphs_matches_jax(exported):
    """Node ids, distances, adjacency, successors and neighbour tables
    equal the JAX loader's, on the numpy path and on the native one (the
    default of both loaders)."""
    _, files = exported
    scans = sorted(make_synthetic_world(**WORLD).graphs)
    for native in (False, True):
        got = load_nav_graphs(files["connectivity_dir"], scans, use_native=native)
        want = jax_load_nav_graphs(files["connectivity_dir"], scans, use_native=native)
        assert sorted(got) == sorted(want) == scans
        for scan in scans:
            g, w = got[scan], want[scan]
            assert g.node_ids == w.node_ids
            for name in ("positions", "adj", "dist", "next_hop", "nbr_index", "nbr_heading",
                         "nbr_elevation", "nbr_point_id", "nbr_mask"):
                np.testing.assert_array_equal(getattr(g, name), getattr(w, name),
                                              err_msg=f"{name} native={native}")
    default = load_nav_graph(files["connectivity_dir"], scans[0])
    native = load_nav_graph(files["connectivity_dir"], scans[0], use_native=True)
    np.testing.assert_array_equal(default.next_hop, native.next_hop)


def test_load_nav_graphs_drops_excluded_and_refuses_one_sided_edges(tmp_path):
    """``included: false`` viewpoints leave the graph, as in the
    reference loader; an edge listed on one side only raises."""
    pose = lambda x: [1, 0, 0, x, 0, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1]
    raw = [{"image_id": f"v{i}", "included": i != 1, "pose": pose(float(i)),
            "unobstructed": [j != i for j in range(3)]} for i in range(3)]
    (tmp_path / "s_connectivity.json").write_text(json.dumps(raw))
    g = load_nav_graph(str(tmp_path), "s")
    assert g.node_ids == ["v0", "v2"] and g.dist[0, 1] == 2.0
    raw[0]["unobstructed"][2] = False
    (tmp_path / "s_connectivity.json").write_text(json.dumps(raw))
    with pytest.raises(ValueError, match="asymmetric"):
        load_nav_graph(str(tmp_path), "s")


def _write_family_annotations(anno_dir):
    """Annotation files of every R2R-family dataset, in the reference's
    names and schemas, plus an aug file; returns the aug path."""
    rng = np.random.default_rng(0)

    def r2r_item(pid, n_instr):
        return {"path_id": pid, "scan": "scan00", "heading": 0.5 * pid,
                "path": [f"vp{pid}", f"vp{pid + 1}"], "distance": 1.0,
                "instructions": [f"walk {j}" for j in range(n_instr)],
                "instr_encodings": [rng.integers(1000, 2000, 10 + 7 * j).tolist()
                                    for j in range(n_instr)]}

    os.makedirs(os.path.join(anno_dir, "LastSent"))
    for si, split in enumerate(("train", "val_seen")):
        for name in (f"R2R_{split}_enc.json", f"LastSent/R2R_{split}_enc.json",
                     f"R4R_{split}_enc.json"):
            with open(os.path.join(anno_dir, name), "w") as f:
                json.dump([r2r_item(100 * si + p, 1 + p % 3) for p in range(4)], f)
        with open(os.path.join(anno_dir, f"rxr_{split}_guide_enc_xlmr.jsonl"), "w") as f:
            for i in range(3):
                f.write(json.dumps({"path_id": 100 * si + i, "instruction_id": 10 + i,
                                    "scan": "scan00",
                                    "heading": 0.0, "path": ["a", "b"], "language": "en-US",
                                    "instr_encoding": rng.integers(5, 250000, 300).tolist()})
                        + "\n\n")
    with open(os.path.join(anno_dir, "rxr_test_standard_public_guide_enc_xlmr.jsonl"), "w") as f:
        f.write(json.dumps({"instruction_id": 77, "scan": "scan00", "heading": 0.0,
                            "path": ["a"], "instr_encoding": [0, 5, 2]}) + "\n")
    aug = os.path.join(anno_dir, "prevalent_aug.json")
    with open(aug, "w") as f:
        json.dump([r2r_item(p, 2) for p in range(10, 13)], f)
    return aug


@pytest.mark.parametrize("dataset,splits", [
    ("r2r", ["train", "val_seen"]), ("r2r_last", ["val_seen"]), ("r4r", ["train"]),
    ("rxr", ["train", "val_seen"]), ("rxr", ["test_standard_public"]), ("r2r", ["aug"]),
], ids=["r2r", "r2r_last", "r4r", "rxr", "rxr_test", "aug_path"])
def test_construct_instrs_matches_jax(tmp_path, dataset, splits):
    aug = _write_family_annotations(str(tmp_path))
    splits = [aug if s == "aug" else s for s in splits]
    max_len = 250 if dataset == "rxr" else 20
    got = tinstr.construct_instrs(str(tmp_path), dataset, splits, max_instr_len=max_len)
    want = jinstr.construct_instrs(str(tmp_path), dataset, splits, max_instr_len=max_len)
    assert got == want and got
    assert all(len(it["instr_encoding"]) <= max_len for it in got)
    assert len({it["instr_id"] for it in got}) == len(got)
    with pytest.raises(FileNotFoundError):
        tinstr.construct_instrs(str(tmp_path), dataset, ["val_unseen"])


def test_hdf5_feature_db_matches_jax(exported):
    """get is bit-equal to the JAX reader's, sliced to feat_dim, and the
    cache holds at most cache_items entries, most recently used last."""
    _, files = exported
    world = make_synthetic_world(**WORLD)
    got = HDF5FeatureDB(files["img_ft_file"], 12, cache_items=3)
    want = JaxHDF5FeatureDB(files["img_ft_file"], 12)
    keys = [(scan, vp) for scan, g in sorted(world.graphs.items()) for vp in g.node_ids[:3]]
    for scan, vp in keys + keys[:2]:
        x = got.get(scan, vp)
        assert x.dtype == np.float32 and x.shape == (36, 12)
        np.testing.assert_array_equal(x, want.get(scan, vp))
        np.testing.assert_array_equal(x, world.feat_db.get(scan, vp)[:, :12])
        assert len(got._cache) <= 3
    assert list(got._cache) == [f"{s}_{v}" for s, v in (keys[-1], keys[0], keys[1])]
    np.testing.assert_array_equal(got.get_image_feature(*keys[2]), want.get(*keys[2]))
    got.close()
    assert not got._file  # an h5py File reads false once closed
