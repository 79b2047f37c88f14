"""The port's greedy evaluation slice against the JAX package's on the
same weights: synthetic world, nav tables and observation expansion
equal; the argmax device rollout equal step for step; and full-split
``eval_split_device`` trajectories and metrics identical."""

import jax
import numpy as np
import pytest
import torch

from vln_hamt_tpu.agents.agent import HAMTAgent as JaxAgent
from vln_hamt_tpu.configs import HAMTConfig as JaxHAMTConfig
from vln_hamt_tpu.data.fixtures import make_synthetic_world as jax_world
from vln_hamt_tpu.data.nav_graph import build_nav_tables as jax_nav_tables
from vln_hamt_tpu.env import ObsSpec as JaxObsSpec
from vln_hamt_tpu.env import R2RNavEnv as JaxEnv
from vln_hamt_tpu.env.observation import expand_obs_np as jax_expand_obs_np
from vln_hamt_torch.agents.agent import HAMTAgent
from vln_hamt_torch.agents.rollout import make_expand_obs
from vln_hamt_torch.configs import HAMTConfig
from vln_hamt_torch.data.fixtures import make_synthetic_world
from vln_hamt_torch.data.nav_graph import build_nav_tables
from vln_hamt_torch.env import ObsSpec, R2RNavEnv
from vln_hamt_torch.env.observation import expand_obs_np
from vln_hamt_torch.ops import attention as tops

# fp32 through the tiny model's 2 text + 2 cross-modal layers
ATOL = 2e-4
WORLD = dict(num_scans=1, nodes_per_scan=12, num_items=8, feat_dim=32, seed=1)


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def tiny_cfg(cls, world, max_action_len=8, batch_size=4):
    """tests/test_agent.py:tiny_cfg for either package's HAMTConfig."""
    feat_dim = world.feat_db.feat_dim
    max_deg = max(g.max_degree for g in world.graphs.values())
    return cls().replace(
        model={"hidden_size": 64, "num_attention_heads": 4, "intermediate_size": 128,
               "num_l_layers": 2, "num_x_layers": 2, "num_h_pano_layers": 1,
               "image_feat_size": feat_dim, "vocab_size": 30522, "max_action_steps": 20,
               "max_position_embeddings": 64, "feat_dropout": 0.1},
        env={"max_action_len": max_action_len, "max_instr_len": 48,
             "max_candidates": max_deg, "image_feat_size": feat_dim},
        train={"batch_size": batch_size, "lr": 1e-3, "ml_weight": 1.0},
    )


def _env(env_cls, spec_cls, world, cfg):
    spec = spec_cls(max_candidates=cfg.env.max_candidates,
                    image_feat_size=cfg.env.image_feat_size)
    return env_cls(world.graphs, world.feat_db, world.instr_data, spec,
                   batch_size=cfg.train.batch_size, max_instr_len=cfg.env.max_instr_len,
                   max_action_len=cfg.env.max_action_len, seed=0)


@pytest.fixture(scope="module")
def agents(tiny_world):
    """A JAX agent and a port agent with the JAX agent's weights, each
    over its own package's copy of the tiny world."""
    world = make_synthetic_world(**WORLD)
    jcfg = tiny_cfg(JaxHAMTConfig, tiny_world)
    cfg = tiny_cfg(HAMTConfig, world)
    jax_agent = JaxAgent(jcfg, _env(JaxEnv, JaxObsSpec, tiny_world, jcfg), seed=0)
    jax_agent.enable_feature_table()
    agent = HAMTAgent(cfg, _env(R2RNavEnv, ObsSpec, world, cfg), seed=0, device="cpu")
    agent.load_flax_params(jax.tree.map(np.asarray, jax_agent.state.params),
                           jax.tree.map(np.asarray, jax_agent.state.cparams))
    agent.enable_feature_table()
    return jax_agent, agent


def test_world_tables_and_obs_expansion_match(tiny_world):
    world = make_synthetic_world(**WORLD)
    assert world.instr_data == tiny_world.instr_data
    assert sorted(world.graphs) == sorted(tiny_world.graphs)
    for scan, g in world.graphs.items():
        jg = tiny_world.graphs[scan]
        assert g.node_ids == jg.node_ids
        for name in ("positions", "adj", "dist", "next_hop", "nbr_index",
                     "nbr_heading", "nbr_elevation", "nbr_point_id"):
            np.testing.assert_array_equal(getattr(g, name), getattr(jg, name), err_msg=name)
        for vp in g.node_ids[:3]:
            np.testing.assert_array_equal(world.feat_db.get(scan, vp),
                                          tiny_world.feat_db.get(scan, vp))
    max_deg = max(g.max_degree for g in world.graphs.values())
    tabs, offs = build_nav_tables(world.graphs, max_deg + 2)
    jtabs, joffs = jax_nav_tables(tiny_world.graphs, max_deg + 2)
    assert offs == joffs
    for k in jtabs:
        np.testing.assert_array_equal(tabs[k], jtabs[k], err_msg=k)

    # device expansion (torch) and both host twins on random compact obs
    rng = np.random.default_rng(0)
    b, c, v, d, a = 3, 5, 36, 8, 4
    pano = rng.standard_normal((b, v, d)).astype(np.float32)
    view = rng.integers(0, 36, b).astype(np.int32)
    cand_point = rng.integers(0, 36, (b, c)).astype(np.int32)
    cand_point[0, 3:] = -1
    cand_point[2, 0] = cand_point[2, 1]  # two candidates on one view
    cand_ang = rng.standard_normal((b, c, a)).astype(np.float32)
    for ob_type in ("pano", "cand"):
        jspec = JaxObsSpec(max_candidates=c, image_feat_size=d, ob_type=ob_type)
        spec = ObsSpec(max_candidates=c, image_feat_size=d, ob_type=ob_type)
        want = jax_expand_obs_np(jspec, pano, view, cand_point, cand_ang)
        host = expand_obs_np(spec, pano, view, cand_point, cand_ang)
        dev = make_expand_obs(v, a, ob_type)(*(torch.from_numpy(x) for x in
                                               (pano, view, cand_point, cand_ang)))
        for key, attr in (("ob_img", "ob_img"), ("ob_ang", "ob_ang"), ("ob_nav", "ob_nav"),
                          ("ob_mask", "ob_mask"), ("hist_img", "hist_img"),
                          ("pano_img", "hist_pano_img"), ("pano_ang", "hist_pano_ang")):
            np.testing.assert_array_equal(getattr(host, attr), getattr(want, attr))
            np.testing.assert_array_equal(dev[key].numpy(), getattr(want, attr), err_msg=key)


def test_greedy_rollout_matches_jax(agents):
    jax_agent, agent = agents
    jfn = jax_agent._ensure_device_rollout_fn()
    jins, _ = jax_agent._device_rollout_args(include_rewards=False)
    st = jax_agent.state
    jep, jextras = jfn(st.params, st.cparams, jins["txt_ids"], jins["txt_mask"],
                       jax.random.PRNGKey(0), jax_agent._feat_table, jax_agent._nav_tables,
                       jins["start_node"], jins["start_view"], jins["offs"], {},
                       deterministic=True, policy="argmax", compute_rewards=False)
    ins = agent._device_rollout_args(include_rewards=False)
    before = dict(tops.launch_counts)
    with torch.no_grad():  # as eval_split_device calls it
        ep, extras = agent._ensure_device_rollout_fn()(
            ins["txt_ids"], ins["txt_mask"], agent._feat_table, agent._nav_tables,
            ins["start_node"], ins["start_view"])
    assert tops.launch_counts == before

    for k in ("txt_ids", "txt_mask", "node_idx", "view_index", "cand_point", "actions",
              "step_mask", "final_node_idx", "final_view_index", "final_cand_point"):
        np.testing.assert_array_equal(ep[k].numpy(), np.asarray(jep[k]), err_msg=k)
    for k in ("cand_ang", "final_cand_ang"):
        np.testing.assert_allclose(ep[k].numpy(), np.asarray(jep[k]), atol=1e-6, err_msg=k)
    assert set(extras) == set(jextras)
    for k in ("masks", "bootstrap_mask", "rewards"):
        np.testing.assert_array_equal(extras[k].numpy(), np.asarray(jextras[k]), err_msg=k)
    got, want = extras["rollout_logits"].numpy(), np.asarray(jextras["rollout_logits"])
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)  # -inf at the same places
    np.testing.assert_allclose(got[fin], want[fin], atol=ATOL, rtol=0)
    np.testing.assert_allclose(extras["values"].numpy(), np.asarray(jextras["values"]),
                               atol=ATOL, rtol=0)


def test_eval_split_device_matches_jax(agents):
    jax_agent, agent = agents
    want = {p["instr_id"]: p for p in jax_agent.eval_split_device()}
    got = {p["instr_id"]: p for p in agent.eval_split_device()}
    assert got.keys() == want.keys()
    for k in want:
        assert got[k]["trajectory"] == want[k]["trajectory"], k
    jm, _ = jax_agent.env.eval_metrics(list(want.values()))
    m, _ = agent.env.eval_metrics(list(got.values()))
    assert m == jm
