"""The port's task-variant envs, fixtures and object loaders against the
JAX package's: R2R-Back, CVDN and REVERIE envs stepped along the same
actions give the same observations (REVERIE's objects with and without
the object table), teacher episodes and metrics; the fixtures build the
same items and object database for a seed; ``load_object_db`` and
``load_obj2viewpoint`` read the same dicts from HDF5 and BBoxes.json files
the test writes, and ``build_object_table`` builds the same tables."""

import json

import numpy as np
import pytest

from vln_hamt_tpu.data import feature_db as jax_fdb
from vln_hamt_tpu.data import fixtures as jax_fx
from vln_hamt_tpu import env as jax_env
from vln_hamt_torch.data import feature_db as fdb
from vln_hamt_torch.data import fixtures as fx
from vln_hamt_torch import env as tenv

WORLD = dict(num_scans=2, nodes_per_scan=14, num_items=12, feat_dim=32, seed=5)
OBS_KEYS = ("pano_feat", "view_index", "cand_node", "cand_point", "cand_ang", "teacher",
            "node", "dist_to_goal", "dist_to_mid", "obj_fts", "obj_angs", "obj_pos",
            "obj_mask", "obj_ids")


def task_items(fxm, world, task):
    """The task's items (and env keywords) of a fresh world, by one
    package's fixtures."""
    if task == "r2r_back":
        return fxm.make_synthetic_r2rback_items(world), {}
    if task == "cvdn":
        return fxm.make_synthetic_cvdn_items(world), {"use_player_path": True}
    obj_db, obj2vp = fxm.add_synthetic_objects(world, obj_feat_size=24, seed=1)
    return world.instr_data, dict(obj_db=obj_db, obj2viewpoint=obj2vp, max_objects=3,
                                  obj_feat_size=24, multi_endpoints=True)


ENV = {"r2r_back": "R2RBackNavEnv", "cvdn": "CVDNNavEnv", "reverie": "ReverieNavEnv"}


def make_env(fxm, envm, task, batch_size=4, **kw):
    world = fxm.make_synthetic_world(**WORLD)
    items, extra = task_items(fxm, world, task)
    spec = envm.ObsSpec(max_candidates=max(g.max_degree for g in world.graphs.values()),
                        image_feat_size=32)
    return getattr(envm, ENV[task])(world.graphs, world.feat_db, items, spec,
                                    batch_size=batch_size, max_action_len=10, seed=3,
                                    **extra, **kw)


def assert_obs_equal(a, b, where):
    for k in OBS_KEYS:
        x, y = getattr(a, k), getattr(b, k)
        if x is None or y is None:
            assert x is None and y is None, (where, k)
        elif isinstance(x, list):
            assert x == y, (where, k)
        else:
            np.testing.assert_array_equal(x, y, err_msg=f"{where} {k}")


@pytest.mark.parametrize("table", [False, True], ids=["host", "table"])
@pytest.mark.parametrize("task", ["r2r_back", "cvdn", "reverie"])
def test_env_matches_jax(task, table):
    """Three batches (the last wraps the split), each stepped along seeded
    random actions (moves and STOPs, -1 once stopped): the same items,
    observations and per-step teacher; then the teacher episode's arrays;
    and the metrics of the random trajectories and of the GT paths."""
    envs = [make_env(fx, tenv, task), make_env(jax_fx, jax_env, task)]
    if table:
        tab = fdb.build_feature_table(envs[0].graphs, envs[0].feat_db)[1]
        for e in envs:
            e.feat_offsets = tab
    rng = np.random.default_rng(0)
    preds = {}
    for batch in range(3):
        obs = [e.reset() for e in envs]
        assert [it["instr_id"] for it in envs[0].batch] == [it["instr_id"]
                                                             for it in envs[1].batch]
        assert envs[0].batch == envs[1].batch  # resampled paths (CVDN, REVERIE)
        paths = {it["instr_id"]: [it["path"][0]] for it in envs[0].batch}
        for t in range(6):
            assert_obs_equal(*obs, f"{task} batch {batch} step {t}")
            ncand = (obs[0].cand_node >= 0).sum(axis=1)
            acts = np.where(rng.random(4) < 0.2, -1,
                            rng.integers(0, 100, 4) % np.maximum(ncand, 1)).astype(np.int32)
            obs = [e.step(acts, o) for e, o in zip(envs, obs)]
            for i, it in enumerate(envs[0].batch):
                if acts[i] >= 0:
                    paths[it["instr_id"]].append(
                        envs[0].graphs[it["scan"]].node_ids[int(obs[0].node[i])])
        for k, v in paths.items():
            preds.setdefault(k, {"instr_id": k, "trajectory": v, "midstop": v[len(v) // 2],
                                 "predObjId": "20"})
    eps = [e.teacher_episode() for e in envs]
    for k in ("txt_ids", "txt_mask", "view_index", "cand_point", "cand_ang", "actions",
              "teacher", "step_mask", "node_idx", "pano_feat"):
        x, y = getattr(eps[0], k), getattr(eps[1], k)
        assert (x is None) == (y is None), k
        if x is not None:
            np.testing.assert_array_equal(x, y, err_msg=k)
    gt = [{"instr_id": it["instr_id"], "trajectory": list(it["path"]),
           "midstop": it.get("midstop"), "predObjId": it.get("objId")}
          for it in envs[0].data if "path" in it]
    for p in (list(preds.values()), gt):
        assert envs[0].eval_metrics(p) == envs[1].eval_metrics(p)


def test_packed_eval_refills_match_jax():
    """``load_item`` and ``clone_shell`` (the packed evaluator's slot
    refills and pipeline groups) of the task envs: CVDN derives a refilled
    item's path, REVERIE's clone keeps its objects."""
    for task in ("cvdn", "reverie"):
        envs = [make_env(fx, tenv, task, batch_size=2),
                make_env(jax_fx, jax_env, task, batch_size=2)]
        items = list(envs[0].data)
        shells = [e.clone_shell(items[3:7]) for e in envs]
        for e in shells:
            e.batch = [None, None]
            e.load_item(0, items[5])
            e.load_item(1, items[6])
        assert shells[0].batch == shells[1].batch
        assert_obs_equal(shells[0]._observe(), shells[1]._observe(), task)


@pytest.mark.parametrize("kind", ["r2r_back", "cvdn", "objects"])
def test_fixtures_match_jax(kind):
    worlds = [fx.make_synthetic_world(**WORLD), jax_fx.make_synthetic_world(**WORLD)]
    if kind == "objects":
        (db, o2v), (jdb, jo2v) = [m.add_synthetic_objects(w, obj_feat_size=24, seed=2)
                                  for m, w in zip((fx, jax_fx), worlds)]
        assert o2v == jo2v and db.keys() == jdb.keys()
        for key in db:
            for k in ("fts", "viewindexs", "bboxes"):
                np.testing.assert_array_equal(db[key][k], jdb[key][k])
            assert db[key]["obj_ids"] == jdb[key]["obj_ids"]
        assert worlds[0].instr_data == worlds[1].instr_data
    else:
        name = f"make_synthetic_{kind.replace('_', '')}_items"
        assert getattr(fx, name)(worlds[0]) == getattr(jax_fx, name)(worlds[1])


def test_object_loaders_match_jax(tmp_path):
    """An object-feature HDF5 file and a BBoxes.json written from a
    fixture object database read back as the JAX loaders read them, and
    the node-aligned object tables equal; the features clipped to
    obj_feat_size, and objects visible from no viewpoint left out."""
    import h5py

    world = fx.make_synthetic_world(**WORLD)
    db, _ = fx.add_synthetic_objects(world, obj_feat_size=24, seed=2)
    # Matterport viewpoint ids hold no "_", which the JAX loaders split
    # keys on (the port splits on the first)
    db = {(scan, vp.replace("_", "")): e for (scan, vp), e in db.items()}
    with h5py.File(tmp_path / "obj.hdf5", "w") as f:
        for (scan, vp), e in db.items():
            ds = f.create_dataset(f"{scan}_{vp}", data=e["fts"])
            ds.attrs["obj_ids"] = e["obj_ids"]
            ds.attrs["bboxes"] = e["bboxes"]
            ds.attrs["viewindexs"] = e["viewindexs"]
    bbox = {}
    for (scan, vp), e in db.items():
        bbox[f"{scan}_{vp}"] = {oid: {"visible_pos": [] if j % 3 == 2 else [1, 2]}
                                for j, oid in enumerate(e["obj_ids"])}
    (tmp_path / "BBoxes.json").write_text(json.dumps(bbox))

    got, want = fdb.load_object_db(str(tmp_path / "obj.hdf5"), 16), \
        jax_fdb.load_object_db(str(tmp_path / "obj.hdf5"), 16)
    assert got.keys() == want.keys() == db.keys()
    for key in got:
        assert got[key]["obj_ids"] == want[key]["obj_ids"] == db[key]["obj_ids"]
        for k in ("fts", "bboxes", "viewindexs"):
            np.testing.assert_array_equal(got[key][k], want[key][k])
        np.testing.assert_array_equal(got[key]["fts"], db[key]["fts"][:, :16])
    o2v = fdb.load_obj2viewpoint(str(tmp_path))
    assert o2v == jax_fdb.load_obj2viewpoint(str(tmp_path)) and o2v

    spec = tenv.ObsSpec(max_candidates=max(g.max_degree for g in world.graphs.values()),
                        image_feat_size=32)
    env = tenv.ReverieNavEnv(world.graphs, world.feat_db, world.instr_data, spec,
                             batch_size=2, obj_db=got, obj2viewpoint=o2v, max_objects=3,
                             obj_feat_size=16)
    # the tables over the graphs' own ids
    graph_db = {(scan, vp): got[(scan, vp.replace("_", ""))]
                for scan, g in world.graphs.items() for vp in g.node_ids}
    tables, offs = fdb.build_object_table(world.graphs, graph_db, 3, 16, env._obj_local_pos)
    jtables, joffs = jax_fdb.build_object_table(world.graphs, graph_db, 3, 16,
                                                env._obj_local_pos)
    assert tables["mask"].any(axis=1).all()
    assert offs == joffs == fdb.build_feature_table(world.graphs, world.feat_db)[1]
    for k in ("fts", "view", "pos", "mask"):
        np.testing.assert_array_equal(tables[k], jtables[k], err_msg=k)
