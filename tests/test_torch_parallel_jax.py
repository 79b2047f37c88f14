"""Data parallelism of the port against the JAX package's: the JAX
``HAMTAgent`` on a ``make_mesh(num_data=2)`` mesh of the conftest's CPU
devices and the port on two rank processes (gloo), both from the JAX
agent's initial weights (carried by ``params_from_flax``), tiny sizes,
fp32, dropout off, SGD: two IL updates, the fused IL + A2C update on a
greedy rollout (the draws the port's sample tests use), the merged
``sample`` update (the teacher episode as lanes of the sampling
rollout) with the argmax put in for both samplers, then the greedy
evaluation of a sharded val split; losses within 2e-4 (the port's
parity bar), the weights (the critic's too) after the updates within
2e-4 and the trajectories identical."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import vln_hamt_tpu.agents.agent as jax_agent_module
from test_torch_parallel import run_ranks
from test_torch_sample import jax_rollout
from test_torch_train import _fast_init_hamt_params, named
from torch_parallel_harness import NO_DROPOUT, TINY_MODEL, TINY_WORLD
from vln_hamt_tpu.agents.agent import HAMTAgent as JaxAgent
from vln_hamt_tpu.configs import HAMTConfig as JaxHAMTConfig
from vln_hamt_tpu.data.fixtures import make_synthetic_world
from vln_hamt_tpu.env import ObsSpec as JaxObsSpec
from vln_hamt_tpu.env import R2RNavEnv as JaxEnv
from vln_hamt_tpu.parallel import mesh as jax_mesh
from vln_hamt_torch.configs import ModelConfig

PARITY = 2e-4


@pytest.fixture(autouse=True)
def fast_jax_init(monkeypatch):
    monkeypatch.setattr(jax_agent_module, "init_hamt_params", _fast_init_hamt_params)


def jax_agent(num_data: int, num_model: int, grad_clip: float = 40.0):
    """The JAX agent of the harness's ``--tiny`` configuration on a
    (num_data, num_model) mesh, and its val env of 8 items."""
    world = make_synthetic_world(**TINY_WORLD)
    mc = max(g.max_degree for g in world.graphs.values())
    cfg = JaxHAMTConfig().replace(
        model={**TINY_MODEL, **NO_DROPOUT},
        env={"max_action_len": 6, "max_instr_len": 24, "image_feat_size": 32,
             "max_candidates": mc},
        train={"batch_size": 4, "optim": "sgd", "lr": 0.05, "grad_clip": grad_clip,
               "ml_weight": 1.0})
    spec = JaxObsSpec(max_candidates=mc, image_feat_size=32)
    kw = dict(batch_size=4, max_instr_len=24, max_action_len=6, seed=0)
    agent = JaxAgent(cfg, JaxEnv(world.graphs, world.feat_db, world.instr_data, spec, **kw),
                     seed=0)
    agent.enable_feature_table()
    agent.enable_mesh(jax_mesh.make_mesh(num_data, num_model,
                                         devices=jax.devices()[:num_data * num_model]))
    val = JaxEnv(world.graphs, world.feat_db, world.instr_data[:8], spec, **kw)
    val.feat_offsets = agent.env.feat_offsets
    return agent, val


def save_flax(agent, path) -> None:
    """The JAX agent's params and cparams as the harness's
    ``--flax_params`` reads them."""
    flat = {}
    for root, tree in (("params", agent.state.params), ("cparams", agent.state.cparams)):
        for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
            flat[f"{root}/{jax_mesh._flatten_path(p)}"] = np.asarray(v)
    np.savez(path, **flat)


def test_data_parallel_matches_jax_mesh(tmp_path, monkeypatch):
    jagent, jval = jax_agent(2, 1)
    save_flax(jagent, tmp_path / "init.npz")
    want = [float(jagent.train_iteration("teacher")["loss"]) for _ in range(2)]
    jil = jagent._ep_to_device(jagent.env.teacher_episode())
    _, _, jep, jex = jax_rollout(jagent, policy="argmax", compute_rewards=True)
    st = jagent.state
    params, cparams, opt_state, copt_state, jloss, _ = jagent._il_rl_update(
        st.params, st.cparams, st.opt_state, st.copt_state, jil, jax.random.PRNGKey(1), 1.0,
        jep, jex["rewards"], jex["masks"], jex["bootstrap_mask"], jax.random.PRNGKey(2),
        jagent._feat_table)
    want.append(float(jloss))
    jagent.state = type(st)(params=params, cparams=cparams, opt_state=opt_state,
                            copt_state=copt_state, step=st.step)
    # the merged sample update with the argmax for its sampler (traced
    # here first, under the replacement)
    jagent.merged_sample_update = True
    with monkeypatch.context() as m:
        m.setattr(jax.random, "categorical",
                  lambda key, logits, axis=-1: jnp.argmax(logits, axis=axis))
        want.append(float(jagent.train_iteration("sample")["loss"]))
    jtraj = {p["instr_id"]: [x[0] for x in p["trajectory"]]
             for p in jagent.eval_split_device(jval)}

    got = run_ranks(tmp_path, "two", 2, "--steps", "il,il,argmax,merged_argmax",
                    "--eval", "device", "--flax_params", str(tmp_path / "init.npz"),
                    "--params_out", str(tmp_path / "p2.npz"))
    np.testing.assert_allclose([r["loss"] for _, r in got["losses"]], want, rtol=PARITY)
    assert got["traj"] == jtraj
    port = np.load(tmp_path / "p2.npz")
    for k, v in named(jagent.state.params, ModelConfig(**TINY_MODEL, **NO_DROPOUT)).items():
        np.testing.assert_allclose(port[k], v, atol=PARITY, rtol=0, err_msg=k)
    for k, v in named(jagent.state.cparams).items():
        np.testing.assert_allclose(port["critic." + k], v, atol=PARITY, rtol=0, err_msg=k)
