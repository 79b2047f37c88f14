"""The port's R2R-Back and CVDN agents against the JAX package's on the
same weights: the host loop's rewards, episode ends and R2R-Back's
midstops; the device rollout's reward branch against the JAX rollout and
against the port's own host loop; the three greedy evaluators; and the
merged update's teacher-forced lanes (the updates against the JAX
package's are in tests/test_torch_variants_updates.py). Set-up from
tests/test_torch_train.py: tiny sizes, dropout off unless stated, one
thread. ``variant_pair`` also serves the REVERIE tests."""

import jax
import numpy as np
import pytest
import torch

import vln_hamt_tpu.agents as jax_agents
from test_torch_replay import assert_logits_close
from test_torch_sample import REWARD_ATOL, REWARD_RTOL, jax_rollout
from test_torch_sample_grads import SAMPLE_KEYS
from test_torch_task_envs import ENV, task_items
from test_torch_train import WORLD, tiny_cfg, train_test_setup  # noqa: F401 (autouse fixture)
from vln_hamt_tpu import env as jax_env
from vln_hamt_tpu.configs import HAMTConfig as JaxHAMTConfig
from vln_hamt_tpu.data import fixtures as jax_fx
from vln_hamt_torch import env as tenv
from vln_hamt_torch.agents.reverie import ReverieAgent
from vln_hamt_torch.agents.variants import CVDNAgent, R2RBackAgent
from vln_hamt_torch.configs import HAMTConfig
from vln_hamt_torch.data import fixtures as fx

AGENT = {"r2r_back": R2RBackAgent, "cvdn": CVDNAgent, "reverie": ReverieAgent}
JAX_AGENT = {"r2r_back": jax_agents.R2RBackAgent, "cvdn": jax_agents.CVDNAgent,
             "reverie": jax_agents.ReverieAgent}
# out and back takes twice R2R's steps
T_MAX = {"r2r_back": 10, "cvdn": 6, "reverie": 6}
OBJ_FEAT = 24


def variant_cfg(cls, world, task, **kw):
    cfg = tiny_cfg(cls, world, max_action_len=T_MAX[task], **kw)
    if task == "reverie":
        cfg = cfg.replace(model={"obj_feat_size": OBJ_FEAT}, env={"max_objects": 3})
    return cfg


def task_env(fxm, envm, world, task, cfg):
    items, extra = task_items(fxm, world, task)
    if task == "reverie":
        # no endpoint resampling: the fixture lists a target object at its
        # home viewpoint, the GT path's end, so the object CE has targets
        extra.update(max_objects=cfg.env.max_objects, obj_feat_size=OBJ_FEAT,
                     multi_endpoints=False)
    spec = envm.ObsSpec(max_candidates=cfg.env.max_candidates,
                        image_feat_size=cfg.env.image_feat_size)
    return getattr(envm, ENV[task])(world.graphs, world.feat_db, items, spec,
                                    batch_size=cfg.train.batch_size,
                                    max_instr_len=cfg.env.max_instr_len,
                                    max_action_len=cfg.env.max_action_len, seed=0, **extra)


def port_agent(task, table=True, seed=0, **kw):
    world = fx.make_synthetic_world(**WORLD)
    cfg = variant_cfg(HAMTConfig, world, task, **kw)
    agent = AGENT[task](cfg, task_env(fx, tenv, world, task, cfg), seed=seed, device="cpu")
    if table:
        agent.enable_feature_table()
    return agent


def variant_pair(task, table=True, **kw):
    """A JAX agent and a port agent (CPU) of ``task`` with the JAX agent's
    weights, each over its own package's copy of the world and items."""
    jworld = jax_fx.make_synthetic_world(**WORLD)
    jcfg = variant_cfg(JaxHAMTConfig, jworld, task, **kw)
    jagent = JAX_AGENT[task](jcfg, task_env(jax_fx, jax_env, jworld, task, jcfg), seed=0)
    agent = port_agent(task, table=table, seed=1, **kw)
    agent.load_flax_params(jax.tree.map(np.asarray, jagent.state.params),
                           jax.tree.map(np.asarray, jagent.state.cparams))
    if table:
        jagent.enable_feature_table()
    return jagent, agent


def vps(preds, extra):
    return {p["instr_id"]: ([x[0] for x in p["trajectory"]], p.get(extra)) for p in preds}


TASKS = ["r2r_back", "cvdn"]
EXTRA = {"r2r_back": "midstop", "cvdn": None}


@pytest.mark.parametrize("task", TASKS)
def test_host_rollout_matches_jax(task):
    """The argmax host loop with rewards over the same batch: the same
    trajectories (and R2R-Back's midstops), actions, live masks, episode
    ends and bootstrap mask; the host hooks' rewards exactly equal;
    logits within 2e-4."""
    jagent, agent = variant_pair(task)
    jtraj, jx = jagent.interactive_rollout("argmax", jax.random.PRNGKey(0),
                                           deterministic=True, record_for_replay=True)
    traj, x = agent.interactive_rollout("argmax", record_for_replay=True)
    assert traj == jtraj
    for k in ("actions", "step_mask", "node_idx", "final_node_idx"):
        np.testing.assert_array_equal(x["ep"][k].numpy(), np.asarray(jx["ep"][k]), err_msg=k)
    for k in ("rewards", "masks", "bootstrap_mask"):
        np.testing.assert_array_equal(x[k].numpy(), np.asarray(jx[k]), err_msg=k)
    assert_logits_close(x["rollout_logits"], jx["rollout_logits"], "logits")
    assert np.abs(x["rewards"].numpy()).sum() > 0


@pytest.mark.parametrize("task", TASKS)
def test_device_rollout_matches_jax_and_host(task):
    """The rewarded argmax device rollout against the JAX device rollout
    on the same batch (trajectories, masks and bootstrap mask equal;
    rewards, logits, values and last_value within tolerance); and the
    port's sampling device rollout against its host loop drawing from the
    same generator state over three batches (actions, masks and bootstrap
    mask equal, rewards within 1e-5), STOPs included (the host loop stops
    drawing once every episode ended, so each batch reseeds both)."""
    jagent, agent = variant_pair(task)
    _, _, jep, jex = jax_rollout(jagent, policy="argmax", compute_rewards=True)
    ins = agent._device_rollout_args()
    assert sorted(ins["task_inputs"]) == sorted(jagent._device_rollout_inputs(
        jagent.env, jagent.env._observe()))
    with torch.no_grad():
        ep, ex = agent._rollout(ins, ins["txt_ids"], ins["txt_mask"], "argmax")
    for k in ("node_idx", "view_index", "actions", "step_mask", "final_node_idx"):
        np.testing.assert_array_equal(ep[k].numpy(), np.asarray(jep[k]), err_msg=k)
    for k in ("masks", "bootstrap_mask"):
        np.testing.assert_array_equal(ex[k].numpy(), np.asarray(jex[k]), err_msg=k)
    np.testing.assert_allclose(ex["rewards"].numpy(), np.asarray(jex["rewards"]),
                               rtol=REWARD_RTOL, atol=REWARD_ATOL)
    assert_logits_close(ex["rollout_logits"], jex["rollout_logits"], "rollout_logits")
    for k in ("values", "last_value"):
        np.testing.assert_allclose(ex[k].numpy(), np.asarray(jex[k]), atol=2e-4, rtol=0)

    host, dev = port_agent(task), port_agent(task)
    stops = 0
    for batch in range(3):
        host.action_rng.manual_seed(batch)
        dev.action_rng.manual_seed(batch)
        _, hx = host.interactive_rollout("sample", record_for_replay=True)
        ins = dev._device_rollout_args()
        with torch.no_grad():
            dep, dx = dev._ensure_device_rollout_fn()(
                ins["txt_ids"], ins["txt_mask"], dev._feat_table, dev._nav_tables,
                ins["start_node"], ins["start_view"], ins["offs"], ins["task_inputs"],
                policy="sample", compute_rewards=True, generator=dev.action_rng)
        for k in ("actions", "step_mask", "node_idx", "final_node_idx"):
            np.testing.assert_array_equal(hx["ep"][k].numpy(), dep[k].numpy(), err_msg=k)
        for k in ("masks", "bootstrap_mask"):
            np.testing.assert_array_equal(hx[k].numpy(), dx[k].numpy(), err_msg=k)
        np.testing.assert_allclose(hx["rewards"].numpy(), dx["rewards"].numpy(), rtol=0,
                                   atol=REWARD_ATOL)
        acts = dep["actions"].numpy()[dep["step_mask"].numpy()]
        stops += int((acts == dev.stop_slot).sum())
    assert stops > 0


def script_stops(agent):
    """Raise STOP's logit at every episode's third and sixth policy step
    and lower it elsewhere (by the history's length, one model for every
    evaluator), so greedy episodes at random weights stop on schedule:
    R2R-Back's take their midstop and then end on their second STOP."""
    plan = agent.model.plan

    def scripted(*args):
        logits, state = plan(*args)
        steps = args[3].sum(dim=1)  # the history mask: 1 + steps taken
        bias = torch.where((steps == 3) | (steps == 6), 10.0, -10.0)
        return logits.index_add(1, torch.tensor([agent.stop_slot]), bias[:, None]), state

    agent.model.plan = scripted


@pytest.mark.parametrize("task", TASKS)
def test_evaluators_match_jax(task):
    """Greedy trajectories (and midstops) of the port's lock-step
    evaluator equal the JAX package's, and so do the metrics; the packed
    evaluator at pipelines 1 and 2 and the device rollout give the
    lock-step's; so they do with scripted STOPs, where R2R-Back's
    episodes take their midstop and end on their second STOP."""
    jagent, agent = variant_pair(task)
    lock = agent.eval_split()
    want = vps(jagent.eval_split(), EXTRA[task])
    assert vps(lock, EXTRA[task]) == want and len(want) == len(agent.env.data)
    assert agent.env.eval_metrics(lock)[0] == jagent.env.eval_metrics(lock)[0]
    for scripted in (False, True):
        if scripted:
            script_stops(agent)
            want = vps(agent.eval_split(), EXTRA[task])
        for pipeline in (1, 2):
            got = vps(agent.eval_split_packed(pipeline=pipeline), EXTRA[task])
            assert got == want, (scripted, pipeline)
        assert vps(agent.eval_split_device(), EXTRA[task]) == want, scripted
    lens = {len(p) for p, _ in want.values()}
    assert lens == ({5} if task == "r2r_back" else {3}), lens  # the stops ended them
    if task == "r2r_back":
        assert all(m == p[2] for p, m in want.values())


@pytest.mark.parametrize("task", TASKS)
def test_merged_lanes_and_train_iteration(task):
    """The merged rollout's teacher-forced lanes give the episode
    forward's logits on the teacher episode; then with dropout on, merged,
    fused and replay train_iteration("sample") give finite losses under
    the JAX package's keys and move the weights."""
    agent = port_agent(task)
    il_ep = agent._teacher_episode()
    ins = agent._device_rollout_args()
    with torch.no_grad():
        _, ex = agent._rollout(ins, torch.cat([ins["txt_ids"], il_ep["txt_ids"]]),
                               torch.cat([ins["txt_mask"], il_ep["txt_mask"]]), "sample",
                               il={k: il_ep[k] for k in ("node_idx", "view_index",
                                                         "actions", "step_mask")})
        ref = agent.episode_forward(il_ep, agent._feat_table).logits
    assert_logits_close(ex["il_logits"], ref.numpy(), "merged il lanes")
    agent = port_agent(task, dropout=True)
    for merged, fused in ((True, False), (False, True), (False, False)):
        agent.merged_sample_update, agent.fused_sample_update = merged, fused
        w0 = agent.model.next_action.net[0].weight.detach().clone()
        out = agent.train_iteration("sample")
        assert set(out) == SAMPLE_KEYS and all(np.isfinite(v) for v in out.values())
        assert not torch.equal(w0, agent.model.next_action.net[0].weight)
