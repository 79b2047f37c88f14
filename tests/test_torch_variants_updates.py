"""The port's R2R-Back and CVDN updates against the JAX package's: one
rollout-then-replay SGD step against the JAX ``_il_rl_update`` on the
same batches and weights, and the fused loss on those batches. Set-up
from tests/test_torch_variants.py."""

import jax
import numpy as np
import pytest

from test_torch_sample_grads import SAMPLE_KEYS, grads_of
from test_torch_train import named, train_test_setup  # noqa: F401 (autouse fixture)
from test_torch_train_grads import assert_grads_close
from test_torch_variants import TASKS, port_agent, variant_pair


@pytest.mark.parametrize("task", TASKS)
def test_replay_sgd_step_matches_jax(task):
    """One rollout-then-replay SGD step on the argmax host-loop rollout
    against the JAX _il_rl_update_fn on its own host-loop rollout of the
    same batch: the loss and its parts, and every model and critic
    gradient (the JAX step's parameter change at lr 1, the port's under
    its clip factor); then the fused loss, with the argmax device rollout
    of the same batches, equals the replay's."""
    lr = 1.0
    jagent, agent = variant_pair(task, fix=False, optim="sgd", lr=lr)
    jil = jagent._ep_to_device(jagent.env.teacher_episode())
    _, jex = jagent.interactive_rollout("argmax", jax.random.PRNGKey(0), deterministic=True,
                                        record_for_replay=True)
    st = jagent.state
    params, cparams, _, _, jloss, jaux = jagent._il_rl_update(
        st.params, st.cparams, st.opt_state, st.copt_state, jil, jax.random.PRNGKey(1),
        agent.cfg.train.ml_weight, jex["ep"], jex["rewards"], jex["masks"],
        jex["bootstrap_mask"], jax.random.PRNGKey(2), jagent._feat_table)

    other = port_agent(task, fix=False, optim="sgd", lr=lr)
    other.model.load_state_dict(agent.model.state_dict())
    other.critic.load_state_dict(agent.critic.state_dict())
    il_ep = agent._teacher_episode()
    start = agent.dropout_rng.get_state()
    _, ex = agent.interactive_rollout("argmax", record_for_replay=True)
    old = {"model": {k: v.clone() for k, v in agent.model.state_dict().items()},
           "critic": {k: v.clone() for k, v in agent.critic.state_dict().items()}}
    loss, aux = agent._update(lambda: agent._replay_sample_loss(il_ep, ex["ep"], ex, start))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for k in SAMPLE_KEYS - {"loss"}:
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    for name, module, want in (("model", agent.model, named(params, agent.cfg.model)),
                               ("critic", agent.critic, named(cparams))):
        got = grads_of(module)
        scale = 1.0
        if name == "model":
            norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in got.values()))
            scale = min(1.0, agent.cfg.train.grad_clip / norm)
        assert_grads_close({k: g * scale for k, g in got.items()},
                           {k: (old[name][k].numpy() - want[k]) / lr for k in want})

    other.model.train()
    other.critic.train()
    il_ep = other._teacher_episode()
    fused, faux = other._fused_sample_loss(il_ep, other._device_rollout_args(), "argmax")
    np.testing.assert_allclose(fused.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(faux["RL_loss"].item(), float(jaux["RL_loss"]), rtol=1e-5)
