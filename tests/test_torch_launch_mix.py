"""``run/profile_attention.py:launch_mix`` and ``bootstrap_mix`` count, by
(Lq, Lk), every attention that a greedy batch, an IL update and the
merged and fused sample updates run: here each call of the plain
forward and backward (the CPU's stand-ins for the kernels) is counted at
a tiny size, for the ``r2r`` preset's frozen text and history stacks,
for trained ones, and under ``no_lang_ca`` (the ``rxr`` and ``r4r``
presets); and for the task variants (R2R-Back, CVDN, REVERIE). On the card ``chip_smoke.py`` holds the kernels' launch
counts to the same mixes."""

import collections

import numpy as np
import pytest
import torch

from test_torch_train import WORLD, make_env, tiny_cfg
from vln_hamt_torch.agents.agent import HAMTAgent
from vln_hamt_torch.configs import HAMTConfig
from vln_hamt_torch.data.fixtures import make_synthetic_world
from vln_hamt_torch.env import ObsSpec, R2RNavEnv
from vln_hamt_torch.ops import attention as tops
from vln_hamt_torch.run.profile_attention import bootstrap_mix, launch_mix


@pytest.fixture
def counted(monkeypatch):
    """Calls of the plain attention forward and backward by (Lq, Lk)."""
    calls = {"fwd": collections.Counter(), "bwd": collections.Counter()}

    def counting(kind, fn):
        def wrapper(q, k, *args):
            calls[kind][(q.shape[2], k.shape[2])] += 1
            return fn(q, k, *args)
        return wrapper

    monkeypatch.setattr(tops, "attention_reference", counting("fwd", tops.attention_reference))
    monkeypatch.setattr(tops, "attention_bwd_reference",
                        counting("bwd", tops.attention_bwd_reference))
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield calls
    torch.set_num_threads(prev)


def _taken(calls):
    out = {k: +v for k, v in calls.items()}
    for v in calls.values():
        v.clear()
    return out


@pytest.mark.parametrize("fix,no_lang_ca", [(True, False), (False, False), (False, True),
                                            (True, True)],
                         ids=["r2r_frozen", "all_trained", "no_lang_ca", "no_lang_ca_frozen"])
def test_launch_mix_counts_every_attention(counted, fix, no_lang_ca):
    world = make_synthetic_world(**WORLD)
    cfg = tiny_cfg(HAMTConfig, world, fix=fix, dropout=True, no_lang_ca=no_lang_ca)
    fwd, bwd = launch_mix(cfg)
    boot = bootstrap_mix(cfg)
    agent = HAMTAgent(cfg, make_env(R2RNavEnv, ObsSpec, world, cfg), seed=0, device="cpu")
    agent.enable_feature_table()

    ins = agent._device_rollout_args(include_rewards=False)
    with torch.no_grad():
        agent._ensure_device_rollout_fn()(ins["txt_ids"], ins["txt_mask"], agent._feat_table,
                                          agent._nav_tables, ins["start_node"],
                                          ins["start_view"])
    assert _taken(counted) == {"fwd": fwd, "bwd": collections.Counter()}

    agent.train_iteration("teacher")
    assert _taken(counted) == {"fwd": fwd, "bwd": bwd}

    agent.merged_sample_update = True
    agent.train_iteration("sample")
    assert _taken(counted) == {"fwd": fwd + boot, "bwd": bwd}

    agent.merged_sample_update = False
    agent.train_iteration("sample")
    assert _taken(counted) == {"fwd": fwd + fwd + boot, "bwd": bwd + bwd}


def test_aug_env_paths_longer_than_the_train_split(counted):
    """The reward's cost slab takes the batch's longest reference path
    when an env that shares the feature table (the aug env beside the
    train env) holds longer paths than the split it was sized on (the
    JAX agent sizes it on the train split alone, and its slab
    assignment fails there)."""
    world = make_synthetic_world(**WORLD)
    cfg = tiny_cfg(HAMTConfig, world, fix=False)
    items = sorted(world.instr_data, key=lambda it: len(it["path"]))
    spec = ObsSpec(max_candidates=cfg.env.max_candidates,
                   image_feat_size=cfg.env.image_feat_size)
    train, aug = (R2RNavEnv(world.graphs, world.feat_db, part, spec, batch_size=3,
                            max_instr_len=cfg.env.max_instr_len,
                            max_action_len=cfg.env.max_action_len, seed=0)
                  for part in (items[:4], items[4:]))
    assert max(len(it["path"]) for it in aug.data) > max(len(it["path"]) for it in train.data)
    agent = HAMTAgent(cfg, train, seed=0, device="cpu")
    agent.enable_feature_table()
    aug.feat_offsets = train.feat_offsets
    agent.env = aug
    for merged in (True, False):
        agent.merged_sample_update = merged
        out = agent.train_iteration("sample")
        assert all(np.isfinite(v) for v in out.values())


@pytest.mark.parametrize("task,kw", [
    ("r2r_back", {"fix": True}), ("cvdn", {"fix": False, "no_lang_ca": True}),
    ("reverie", {"fix": False, "no_lang_ca": True}), ("reverie", {"fix": True})],
    ids=["r2r_back", "cvdn", "reverie", "reverie_ob_txt"])
def test_launch_mix_counts_the_variants(counted, task, kw):
    """The task variants at their presets' layouts: R2R-Back's frozen
    stacks, CVDN's and REVERIE's no_lang_ca with every stack trained
    (REVERIE's visual stream with its object tokens and no precomputed
    language half), through the greedy device rollout, the IL update
    (REVERIE's dual CE: the object head adds no attention) and the
    merged and fused sample updates."""
    from test_torch_variants import port_agent

    agent = port_agent(task, dropout=True, **kw)
    fwd, bwd = launch_mix(agent.cfg)
    boot = bootstrap_mix(agent.cfg)
    if task == "reverie":
        lk = agent.cfg.env.max_action_len + 1 + agent.num_ob_tokens + agent.cfg.env.max_objects
        assert (lk, lk) in fwd
    ins = agent._device_rollout_args(include_rewards=False)
    with torch.no_grad():
        agent._ensure_device_rollout_fn()(ins["txt_ids"], ins["txt_mask"], agent._feat_table,
                                          agent._nav_tables, ins["start_node"],
                                          ins["start_view"], obj_tables=agent._obj_tables)
    assert _taken(counted) == {"fwd": fwd, "bwd": collections.Counter()}
    agent.train_iteration("teacher")
    assert _taken(counted) == {"fwd": fwd, "bwd": bwd}
    agent.merged_sample_update = True
    agent.train_iteration("sample")
    assert _taken(counted) == {"fwd": fwd + boot, "bwd": bwd}
    agent.merged_sample_update = False
    agent.train_iteration("sample")
    assert _taken(counted) == {"fwd": fwd + fwd + boot, "bwd": bwd + bwd}
