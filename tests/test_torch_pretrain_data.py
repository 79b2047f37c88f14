"""The port's pretraining data against the JAX package's: the copied
trajectory records, datasets and task batchers give the same arrays for
the same seeds (both observation layouts, feature and index mode), the
on-device index expansion reproduces the host's feature batches and the
JAX package's expansion, and the task scheduler and LR schedules draw
as the JAX package's do. Numpy and CPU torch; the JAX side runs on the
CPU."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vln_hamt_tpu.configs import ModelConfig as JaxModelConfig
from vln_hamt_tpu.data.feature_db import build_feature_table as jax_build_feature_table
from vln_hamt_tpu.data.fixtures import make_synthetic_world as jax_world
from vln_hamt_tpu.pretrain import tasks as jax_tasks
from vln_hamt_tpu.pretrain import trajectory_data as jax_td
from vln_hamt_tpu.pretrain.model import expand_index_batch as jax_expand
from vln_hamt_tpu.pretrain.optim import noam_schedule as jax_noam
from vln_hamt_tpu.pretrain.optim import warmup_linear_schedule as jax_warmup_linear
from vln_hamt_tpu.pretrain.trainer import TaskScheduler as JaxTaskScheduler
from vln_hamt_tpu.run.build_trajectories import derive_record as jax_derive_record
from vln_hamt_torch.configs import ModelConfig
from vln_hamt_torch.data.feature_db import build_feature_table
from vln_hamt_torch.data.fixtures import make_synthetic_world
from vln_hamt_torch.pretrain import tasks, trajectory_data as td
from vln_hamt_torch.pretrain.model import batch_to_device, expand_index_batch
from vln_hamt_torch.pretrain.optim import noam_schedule, warmup_linear_schedule
from vln_hamt_torch.pretrain.trainer import TaskScheduler
from vln_hamt_torch.run.build_trajectories import derive_record

WORLD = dict(num_scans=1, nodes_per_scan=12, num_items=10, feat_dim=48, seed=2)
DS = dict(image_feat_size=32, image_prob_size=16, max_txt_len=32, max_hist_len=6)
TASKS = tasks.TASK_NAMES


def _dataset(pkg_td, world, recs, index_mode, cand, build_table):
    ds = pkg_td.TrajectoryDataset(recs, world.graphs, world.feat_db, ob_cand_pano_view=cand,
                                  ob_cand_extra=8, **DS)
    if index_mode:
        ds.set_feat_offsets(build_table(world.graphs, world.feat_db)[1])
    return ds


@pytest.fixture(scope="module")
def worlds():
    jw, w = jax_world(**WORLD), make_synthetic_world(**WORLD)
    return (jw, jax_td.make_synthetic_trajectories(jw)), (w, td.make_synthetic_trajectories(w))


def assert_same_arrays(got, want, what):
    assert got.keys() == want.keys(), what
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, (what, k, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{what} {k}")


def test_trajectories_match_jax(worlds):
    (_, jrecs), (_, recs) = worlds
    assert len(recs) == len(jrecs)
    for r, j in zip(recs, jrecs):
        assert (r.scan, r.path, r.instr_ids, r.instr_encodings) == \
            (j.scan, j.path, j.instr_ids, j.instr_encodings)
        for k in ("path_viewindex", "action_viewindex", "rel_act_angles"):
            np.testing.assert_array_equal(getattr(r, k), getattr(j, k))
    np.testing.assert_array_equal(td.standardize_radians(np.linspace(-9, 9, 37)),
                                  jax_td.standardize_radians(np.linspace(-9, 9, 37)))
    np.testing.assert_array_equal(tasks.sprel_target_table(), jax_tasks.sprel_target_table())


def test_trajectory_jsonl_and_build_trajectories_match_jax(worlds, tmp_path):
    """build_trajectories' record derivation and the JSONL loader."""
    (jw, _), (w, recs) = worlds
    lines = []
    for item, jitem in zip(w.instr_data, jw.instr_data):
        it = {**item, "instr_encodings": [item["instr_encoding"]], "path_id": item["instr_id"]}
        jit_ = {**jitem, "instr_encodings": [jitem["instr_encoding"]],
                "path_id": jitem["instr_id"]}
        got = derive_record(w.graphs[item["scan"]], it)
        assert got == jax_derive_record(jw.graphs[jitem["scan"]], jit_)
        lines.append(json.dumps(got))
    path = tmp_path / "traj.jsonl"
    path.write_text("\n".join(lines) + "\n")
    loaded, jloaded = td.load_trajectory_jsonl([str(path)]), jax_td.load_trajectory_jsonl(
        [str(path)])
    for r, j, s in zip(loaded, jloaded, recs):
        np.testing.assert_array_equal(r.path_viewindex, j.path_viewindex)
        np.testing.assert_array_equal(r.action_viewindex, s.action_viewindex)
        np.testing.assert_array_equal(r.rel_act_angles, j.rel_act_angles)


@pytest.mark.parametrize("cand", [False, True], ids=["pano", "cand_first"])
@pytest.mark.parametrize("index_mode", [False, True], ids=["features", "index"])
def test_batches_match_jax(worlds, index_mode, cand):
    """Every task's batch, several draws in a row: the same numpy stream
    (masking, negatives, kills, anchors) and the same arrays."""
    (jw, jrecs), (w, recs) = worlds
    jb = jax_tasks.PretrainBatcher(_dataset(jax_td, jw, jrecs, index_mode, cand,
                                            jax_build_feature_table), seed=3,
                                   vocab_mask_range=(1000, 2000))
    b = tasks.PretrainBatcher(_dataset(td, w, recs, index_mode, cand, build_feature_table),
                              seed=3, vocab_mask_range=(1000, 2000))
    for _ in range(2):
        for task in TASKS:
            assert_same_arrays(b.batch(task, 4), jb.batch(task, 4), task)
    for task in TASKS:
        assert b.n_examples(task) == jb.n_examples(task)
        assert b.ordered_refs(task, 5, 4) == jb.ordered_refs(task, 5, 4)
        assert_same_arrays(b.batch(task, 4, refs=b.ordered_refs(task, 2, 4)),
                           jb.batch(task, 4, refs=jb.ordered_refs(task, 2, 4)), task)


@pytest.mark.parametrize("cand", [False, True], ids=["pano", "cand_first"])
def test_expand_index_batch_matches_feature_mode_and_jax(worlds, cand):
    """The on-device gather of an index-mode batch equals the host's
    feature-mode batch of the same seed (MRC masking and soft labels,
    STOP token, kills, the candidate-first permutation) and the JAX
    package's expansion of the same index batch."""
    _, (w, recs) = worlds
    table, _ = build_feature_table(w.graphs, w.feat_db)
    cfg = ModelConfig(image_feat_size=32, image_prob_size=16)
    jcfg = JaxModelConfig(image_feat_size=32, image_prob_size=16)
    fb = tasks.PretrainBatcher(_dataset(td, w, recs, False, cand, build_feature_table), seed=5)
    ib = tasks.PretrainBatcher(_dataset(td, w, recs, True, cand, build_feature_table), seed=5)
    for task in TASKS:
        host, idx = fb.batch(task, 4), ib.batch(task, 4)
        assert "hist_node" in idx and "hist_img" not in idx
        got = expand_index_batch(batch_to_device(idx, "cpu"), torch.from_numpy(table), cfg)
        want = batch_to_device(host, "cpu")
        assert got.keys() == want.keys(), task
        for k in want:
            atol = 1e-7 if k == "hist_img_probs" else 0.0  # softmax on both sides
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=atol, msg=f"{task} {k}")
        jgot = jax_expand({k: jnp.asarray(v) for k, v in idx.items()}, jnp.asarray(table), jcfg)
        assert jgot.keys() == got.keys(), task
        for k in jgot:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(jgot[k]), rtol=0, atol=1e-7,
                                       err_msg=f"{task} {k}")


def test_scheduler_and_schedules_match_jax():
    mix = (5, 1, 1, 1, 2, 2)
    s, js = TaskScheduler(TASKS, mix, seed=7), JaxTaskScheduler(TASKS, mix, seed=7)
    seq = [s.sample(i) for i in range(300)]
    assert seq == [js.sample(i) for i in range(300)]
    assert seq.count("mlm") > seq.count("mrc")
    for ours, theirs in ((warmup_linear_schedule(1e-3, 10, 100), jax_warmup_linear(1e-3, 10, 100)),
                         (warmup_linear_schedule(5e-5, 0, 7), jax_warmup_linear(5e-5, 0, 7)),
                         (noam_schedule(1e-3, 100), jax_noam(1e-3, 100))):
        for step in (0, 1, 5, 9, 10, 11, 55, 99, 100, 150, 10_000):
            np.testing.assert_allclose(ours(step), float(theirs(step)), rtol=1e-6, atol=0,
                                       err_msg=str(step))
    w = warmup_linear_schedule(1e-3, 10, 100)
    assert w(0) == 0.0 and w(10) == pytest.approx(1e-3) and w(100) == 0.0
    with pytest.raises(ValueError, match="mix ratios"):
        TaskScheduler(TASKS, (1, 2))
