"""The port's REVERIE updates against the JAX package's on the same
weights and batches: the teacher episode (dual targets) and its dual CE
with every gradient against jax.grad of ``_ref_il_loss``; one
rollout-then-replay SGD step against ``_ref_il_rl_update`` and the fused
loss on the same batches; the merged update's teacher-forced lanes (act
and object logits) against the episode forward; and every ``sample``
update through ``train_iteration``. Set-up from
tests/test_torch_variants.py: tiny sizes, dropout off unless stated, one
thread."""

import jax
import numpy as np
import torch

from test_torch_replay import assert_logits_close
from test_torch_sample_grads import SAMPLE_KEYS, grads_of
from test_torch_train import named, train_test_setup  # noqa: F401 (autouse fixture)
from test_torch_train_grads import assert_grads_close
from test_torch_variants import port_agent, variant_pair


def test_teacher_episode_dual_ce_and_grads_match_jax():
    """The teacher episode's actions (the object stop as the appended
    slot), teacher and object targets equal the JAX agent's; the dual CE
    and every model gradient (the object embeddings and head included)
    match jax.grad of _ref_il_loss; the critic takes none."""
    jagent, agent = variant_pair("reverie", fix=False, no_lang_ca=True)
    jep = jagent._ref_teacher_episode()
    ep = agent._teacher_episode()
    for k in ("actions", "teacher", "ref_teacher", "step_mask", "node_idx"):
        np.testing.assert_array_equal(ep[k].numpy(), np.asarray(jep[k]), err_msg=k)
    assert (ep["ref_teacher"].numpy() >= 0).any()
    assert (ep["actions"].numpy() == agent.stop_action).any()
    st = jagent.state
    (jloss, _), (jgp, _) = jax.jit(jax.value_and_grad(
        lambda p, c: jagent._ref_il_loss(p, c, jep, jax.random.PRNGKey(0), 1.0,
                                         jagent._feat_table, jagent._obj_tables),
        argnums=(0, 1), has_aux=True))(st.params, st.cparams)
    agent.model.train()
    loss = agent._il_loss(ep, 1.0)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    got = grads_of(agent.model)
    assert np.abs(got["ref_object.net.0.weight"]).max() > 0
    assert_grads_close(got, named(jgp, agent.cfg.model))
    assert all(p.grad is None for p in agent.critic.parameters())


def test_replay_sgd_step_and_fused_loss_match_jax():
    """One rollout-then-replay SGD step on the argmax host-loop rollout
    (dual CE + A2C) against the JAX _ref_il_rl_update on its own host-loop
    rollout of the same batch: the loss and its parts, and every model and
    critic gradient (the JAX step's change at lr 1, the port's under its
    clip factor); then the fused loss on the argmax device rollout of the
    same batches equals it."""
    lr = 1.0
    jagent, agent = variant_pair("reverie", fix=False, no_lang_ca=True, optim="sgd", lr=lr)
    other = port_agent("reverie", fix=False, no_lang_ca=True, optim="sgd", lr=lr)
    other.model.load_state_dict(agent.model.state_dict())
    other.critic.load_state_dict(agent.critic.state_dict())
    jil = jagent._ref_teacher_episode()
    _, jex = jagent.interactive_rollout("argmax", jax.random.PRNGKey(0), deterministic=True,
                                        record_for_replay=True)
    st = jagent.state
    params, cparams, _, _, jloss, jaux = jagent._ref_il_rl_update(
        st.params, st.cparams, st.opt_state, st.copt_state, jil, jax.random.PRNGKey(1),
        agent.cfg.train.ml_weight, jex["ep"], jex["rewards"], jex["masks"],
        jex["bootstrap_mask"], jax.random.PRNGKey(2), jagent._feat_table, jagent._obj_tables)

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
    fused, faux = other._fused_sample_loss(other._teacher_episode(),
                                           other._device_rollout_args(), "argmax")
    np.testing.assert_allclose(fused.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(faux["RL_loss"].item(), float(jaux["RL_loss"]), rtol=1e-5)


def test_merged_lanes_and_sample_updates():
    """The merged rollout's teacher-forced lanes give the episode
    forward's action and object logits; with dropout on, merged, fused and
    replay train_iteration("sample") (the replay's rollout on the device,
    then on the host loop without the tables) give finite losses under the
    JAX package's keys and move the object head."""
    agent = port_agent("reverie", no_lang_ca=True)
    il_ep = agent._teacher_episode()
    ins = agent._device_rollout_args()
    with torch.no_grad():
        _, ex = agent._rollout(ins, torch.cat([ins["txt_ids"], il_ep["txt_ids"]]),
                               torch.cat([ins["txt_mask"], il_ep["txt_mask"]]), "sample",
                               il={k: il_ep[k] for k in ("node_idx", "view_index",
                                                         "actions", "step_mask")})
        ref = agent.episode_forward(il_ep, agent._feat_table, agent._obj_tables)
    assert_logits_close(ex["il_logits"], ref.logits.numpy(), "merged act lanes")
    assert_logits_close(ex["il_obj_logits"], ref.obj_logits.numpy(), "merged object lanes")
    for table in (True, False):
        agent = port_agent("reverie", table=table, dropout=True, no_lang_ca=True)
        modes = ((True, False), (False, True), (False, False)) if table else ((False, False),)
        for merged, fused in modes:
            agent.merged_sample_update, agent.fused_sample_update = merged, fused
            w0 = agent.model.ref_object.net[0].weight.detach().clone()
            out = agent.train_iteration("sample")
            assert set(out) == SAMPLE_KEYS and all(np.isfinite(v) for v in out.values())
            assert not torch.equal(w0, agent.model.ref_object.net[0].weight)
