"""Gradients of the port's ``sample`` update against the JAX package: A2C
through the differentiable rollout against the JAX replay (``_rl_loss``),
one SGD step of IL + A2C against ``_il_rl_update_fn``, and the port's
own replay against its rollout; on the port alone, the merged and fused
``train_iteration("sample")``. Set-up from tests/test_torch_train.py:
tiny sizes, dropout off unless stated, one thread."""

import jax
import numpy as np
import pytest
import torch

from test_torch_sample import jax_rollout
from test_torch_train import (WORLD, make_env, make_pair, named, tiny_cfg,
                              train_test_setup)  # noqa: F401 (autouse fixture)
from test_torch_train_grads import assert_grads_close
from vln_hamt_torch.agents.agent import HAMTAgent
from vln_hamt_torch.configs import HAMTConfig
from vln_hamt_torch.data.fixtures import make_synthetic_world
from vln_hamt_torch.env import ObsSpec, R2RNavEnv
from vln_hamt_torch.ops import attention as tops

# the aux keys of the JAX agent's sample updates (agents/agent.py:
# _fused_sample_update_fn and _merged_sample_update_fn), plus the loss
SAMPLE_KEYS = {"loss", "IL_loss", "RL_loss", "policy_loss", "critic_loss", "entropy",
               "total_actions"}


def grads_of(module):
    return {k: (p.grad.numpy() if p.grad is not None else np.zeros(p.shape, np.float32))
            for k, p in module.named_parameters()}


@pytest.mark.parametrize("fix", [True, False], ids=["fixed_embeddings", "all_trained"])
def test_a2c_gradients_match_jax_replay(tiny_world, fix):
    """A2C on the port's argmax rollout, differentiated through the
    rollout, against jax.grad of the JAX _rl_loss replayed on the
    JAX-recorded episode: the loss, and every model and critic gradient;
    with fix_lang_embedding / fix_hist_embedding the frozen parts get no
    gradient inside the rollout either."""
    jagent, agent = make_pair(tiny_world, fix=fix)
    _, _, jep, jex = jax_rollout(jagent, policy="argmax", compute_rewards=True)
    st = jagent.state
    (jloss, _), (jgp, jgc) = jax.jit(jax.value_and_grad(
        lambda p, c: jagent._rl_loss(p, c, jep, jex["rewards"], jex["masks"],
                                     jex["bootstrap_mask"], jax.random.PRNGKey(1),
                                     jagent._feat_table),
        argnums=(0, 1), has_aux=True))(st.params, st.cparams)

    ins = agent._device_rollout_args()
    agent.model.train()
    agent.critic.train()
    ep, ex = agent._rollout(ins, ins["txt_ids"], ins["txt_mask"], "argmax")
    np.testing.assert_array_equal(ep["actions"].numpy(), np.asarray(jep["actions"]))
    assert not ex["rewards"].requires_grad and not ex["last_value"].requires_grad
    loss, aux = agent._rollout_a2c(ep, ex)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert_grads_close(grads_of(agent.model), named(jgp, agent.cfg.model))
    assert_grads_close(grads_of(agent.critic), named(jgc))
    frozen = [k for k, p in agent.model.named_parameters() if p.grad is None]
    if fix:
        assert "embeddings.word_embeddings.weight" in frozen
        assert "hist_embeddings.pano_encoder.layer.0.attention.self.query.weight" in frozen
    assert all(p.grad is not None for p in agent.critic.parameters())


def test_sgd_il_rl_step_matches_jax(tiny_world):
    """One SGD step of the fused loss (IL on the teacher episode + A2C on
    the argmax rollout) against the JAX _il_rl_update_fn on the same
    teacher episode and the JAX-recorded rollout: loss and every model
    and critic parameter after the step."""
    jagent, agent = make_pair(tiny_world, fix=False, optim="sgd", lr=0.05)
    jil = jagent._ep_to_device(jagent.env.teacher_episode())  # the update's host order
    _, _, jep, jex = jax_rollout(jagent, policy="argmax", compute_rewards=True)
    st = jagent.state
    ml = agent.cfg.train.ml_weight
    params, cparams, _, _, jloss, jaux = jagent._il_rl_update(
        st.params, st.cparams, st.opt_state, st.copt_state, jil, jax.random.PRNGKey(1), ml,
        jep, jex["rewards"], jex["masks"], jex["bootstrap_mask"], jax.random.PRNGKey(2),
        jagent._feat_table)

    il_ep = agent._ep_to_device(agent.env.teacher_episode())
    ins = agent._device_rollout_args()
    loss, aux = agent._update(lambda: agent._fused_sample_loss(il_ep, ins, policy="argmax"))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for k in ("IL_loss", "RL_loss", "policy_loss", "critic_loss", "entropy",
              "total_actions"):
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    for module, want in ((agent.model, named(params, agent.cfg.model)),
                         (agent.critic, named(cparams))):
        for k, v in module.state_dict().items():
            np.testing.assert_allclose(v.numpy(), want[k], atol=1e-5, rtol=0, err_msg=k)


def test_rl_replay_equals_rollout_loss(tiny_world):
    """The port's _rl_loss, replaying the recorded rollout through the
    teacher-forced episode forward, gives the loss and gradients of A2C
    differentiated through the rollout itself (the JAX package's
    replay-parity invariant, which the fused update rests on)."""
    _, agent = make_pair(tiny_world, fix=False)
    ins = agent._device_rollout_args()
    agent.model.train()
    agent.critic.train()
    ep, ex = agent._rollout(ins, ins["txt_ids"], ins["txt_mask"], "argmax")
    loss, _ = agent._rollout_a2c(ep, ex)
    loss.backward()
    want = {**grads_of(agent.model), **{"critic." + k: v for k, v in
                                        grads_of(agent.critic).items()}}
    agent.model.zero_grad(set_to_none=True)
    agent.critic.zero_grad(set_to_none=True)
    replay = {k: v.detach() for k, v in ep.items()}
    loss_r, _ = agent._rl_loss(replay, ex["rewards"], ex["masks"], ex["bootstrap_mask"])
    loss_r.backward()
    got = {**grads_of(agent.model), **{"critic." + k: v for k, v in
                                       grads_of(agent.critic).items()}}
    np.testing.assert_allclose(loss_r.item(), loss.item(), rtol=1e-6)
    assert_grads_close(got, want)


@pytest.mark.parametrize("merged", [True, False], ids=["merged", "fused"])
def test_train_iteration_sample(merged):
    """train_iteration("sample") with dropout on: finite losses under the
    JAX package's keys, the parameters move, and two agents with one
    seed give the same losses (every draw comes from the agent's own
    generators). No kernel launches on the CPU."""
    world = make_synthetic_world(**WORLD)
    cfg = tiny_cfg(HAMTConfig, world, dropout=True)
    runs = []
    for _ in range(2):
        agent = HAMTAgent(cfg, make_env(R2RNavEnv, ObsSpec, world, cfg), seed=0,
                          device="cpu")
        agent.enable_feature_table()
        agent.merged_sample_update = merged
        before = dict(tops.launch_counts)
        w0 = agent.model.next_action.net[0].weight.detach().clone()
        runs.append([agent.train_iteration("sample") for _ in range(2)])
        assert tops.launch_counts == before
        assert not torch.equal(w0, agent.model.next_action.net[0].weight)
        assert agent.step == 2 and agent.logs["RL_loss"] == [o["RL_loss"] for o in runs[-1]]
    for out in runs[0]:
        assert set(out) == SAMPLE_KEYS
        assert all(np.isfinite(v) for v in out.values())
        assert out["total_actions"] >= agent.cfg.train.batch_size
    assert runs[0] == runs[1]
    assert runs[0][0]["loss"] != runs[0][1]["loss"]
