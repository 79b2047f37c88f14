"""The port's host-loop evaluators: ``eval_split`` (lock-step) against the
JAX package's on the same weights, with and without ``no_cand_backtrack``
and under ``no_lang_ca``; ``eval_split_packed`` (pipelines 1 and 2) and
``eval_split_device`` against ``eval_split``; a split smaller than a
batch; evaluation without the feature table; and the fine-tuning CLI
with ``--no_cand_backtrack``. Tiny sizes, one thread."""

import jax
import numpy as np
import pytest
import torch

import vln_hamt_tpu.agents.agent as jax_agent_module
from test_torch_eval import WORLD, _env, one_thread, tiny_cfg  # noqa: F401 (autouse fixture)
from test_torch_train import _fast_init_hamt_params
from vln_hamt_tpu.agents.agent import HAMTAgent as JaxAgent
from vln_hamt_tpu.configs import HAMTConfig as JaxHAMTConfig
from vln_hamt_tpu.env import ObsSpec as JaxObsSpec
from vln_hamt_tpu.env import R2RNavEnv as JaxEnv
from vln_hamt_torch.agents.agent import HAMTAgent
from vln_hamt_torch.configs import HAMTConfig
from vln_hamt_torch.data.fixtures import make_synthetic_world
from vln_hamt_torch.env import ObsSpec, R2RNavEnv
from vln_hamt_torch.run import finetune


@pytest.fixture(scope="module", params=["ob_txt", "no_lang_ca"])
def pair(request, tiny_world):
    """A JAX agent and a port agent with its weights, both with the
    feature table; the tiny model, or its no_lang_ca variant (the rxr
    and r4r presets' layout)."""
    variant = {"no_lang_ca": request.param == "no_lang_ca"}
    world = make_synthetic_world(**WORLD)
    jcfg = tiny_cfg(JaxHAMTConfig, tiny_world).replace(model=variant)
    cfg = tiny_cfg(HAMTConfig, world).replace(model=variant)
    with pytest.MonkeyPatch.context() as mp:  # the JAX init under jit
        mp.setattr(jax_agent_module, "init_hamt_params", _fast_init_hamt_params)
        jagent = JaxAgent(jcfg, _env(JaxEnv, JaxObsSpec, tiny_world, jcfg), seed=0)
    jagent.enable_feature_table()
    agent = HAMTAgent(cfg, _env(R2RNavEnv, ObsSpec, world, cfg), seed=0, device="cpu")
    agent.load_flax_params(jax.tree.map(np.asarray, jagent.state.params),
                           jax.tree.map(np.asarray, jagent.state.cparams))
    agent.enable_feature_table()
    return jagent, agent


def by_id(preds):
    return {p["instr_id"]: p["trajectory"] for p in preds}


def assert_no_revisit(preds):
    for p in preds:
        vps = [x[0] for x in p["trajectory"]]
        assert len(vps) == len(set(vps)), p


def test_eval_split_matches_jax(pair):
    """Lock-step greedy trajectories equal the JAX package's, pose for
    pose, with and without no_cand_backtrack, and so do the metrics."""
    jagent, agent = pair
    runs = []
    for backtrack in (False, True):
        want = by_id(jagent.eval_split(no_cand_backtrack=backtrack))
        preds = agent.eval_split(no_cand_backtrack=backtrack)
        assert by_id(preds) == want
        assert len(want) == len(agent.env.data)
        runs.append(want)
    assert_no_revisit(preds)
    assert runs[0] != runs[1]  # the greedy policy revisits without the mask
    jm, _ = jagent.env.eval_metrics([{"instr_id": k, "trajectory": v}
                                     for k, v in want.items()])
    assert agent.env.eval_metrics(preds)[0] == jm


def test_packed_and_device_evaluators_match_lockstep(pair):
    """The packed evaluator at pipelines 1 and 2 and the device rollout
    give the lock-step trajectories; with no_cand_backtrack the packed
    evaluator gives the lock-step's, with no revisit; eval_split_fast
    takes the device rollout, and the packed evaluator when
    no_cand_backtrack is on."""
    _, agent = pair
    lock = by_id(agent.eval_split())
    for pipeline in (1, 2):
        assert by_id(agent.eval_split_packed(pipeline=pipeline)) == lock, pipeline
    dev = by_id(agent.eval_split_device())
    assert dev.keys() == lock.keys()
    for k in lock:
        assert [x[0] for x in dev[k]] == [x[0] for x in lock[k]], k
        for (_, h, e), (_, lh, le) in zip(dev[k], lock[k]):
            assert abs(h - lh) < 1e-6 and abs(e - le) < 1e-6

    lock_nb = by_id(agent.eval_split(no_cand_backtrack=True))
    assert_no_revisit(agent.eval_split(no_cand_backtrack=True))
    for pipeline in (1, 2):
        got = agent.eval_split_packed(no_cand_backtrack=True, pipeline=pipeline)
        assert by_id(got) == lock_nb, pipeline
    assert by_id(agent.eval_split_fast(no_cand_backtrack=True)) == lock_nb
    assert by_id(agent.eval_split_fast()) == dev


def test_packed_eval_tiny_split(pair):
    """A split smaller than a batch: the slots fill by cycling the items
    and the duplicates keep the first prediction, so each item is
    predicted once, as lock-step predicts it (JAX
    tests/test_agent.py::test_packed_eval_tiny_split)."""
    _, agent = pair
    items = list(agent.env.data)[: agent.env.batch_size - 1]
    small = agent.env.clone_shell(items)
    lock = by_id(agent.eval_split(small))
    packed = by_id(agent.eval_split_packed(small))
    assert set(packed) == {it["instr_id"] for it in items}
    assert packed == lock


def test_host_loop_without_feature_table(pair):
    """Panoramas shipped per step instead of gathered from the resident
    table: the same lock-step and packed trajectories."""
    _, agent = pair
    want = by_id(agent.eval_split())
    world = make_synthetic_world(**WORLD)
    bare = HAMTAgent(agent.cfg, _env(R2RNavEnv, ObsSpec, world, agent.cfg), seed=1,
                     device="cpu")
    bare.model.load_state_dict(agent.model.state_dict())
    bare.critic.load_state_dict(agent.critic.state_dict())
    assert bare.env.feat_offsets is None and bare._feat_table is None
    assert by_id(bare.eval_split()) == want
    assert by_id(bare.eval_split_fast()) == want  # the packed evaluator


def test_cli_no_cand_backtrack_on_cpu(tmp_path):
    """--no_cand_backtrack trains and evaluates through the packed
    evaluator to its metrics record."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        best = finetune.main(["--task", "r2r", "--synthetic", "--tiny", "--cpu",
                              "--no_cand_backtrack", "--iters", "2", "--log_every", "2",
                              "--output_dir", str(tmp_path)])
    finally:
        torch.set_num_threads(prev)
    assert best["iter"] == 2 and 0.0 <= best["sr"] <= 100.0
    assert '"val_unseen/sr"' in (tmp_path / "metrics.jsonl").read_text()
