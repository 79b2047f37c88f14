"""The port's rollout-then-replay ``sample`` update: the host-loop and
the device sampling rollouts from the same generator states; the
replay's logits against the rollout's with dropout on (the replay draws
the rollout's own masks); one SGD step against the JAX package's
``_il_rl_update_fn`` on the same episode and weights; and
``train_iteration("sample")`` through the replay, with and without the
feature table, and the CLI's ``--no_feat_table``. Set-up from
tests/test_torch_train.py: tiny sizes, one thread."""

import jax
import numpy as np
import pytest
import torch

from test_torch_sample import REWARD_ATOL, REWARD_RTOL, assert_logits_close
from test_torch_sample_grads import SAMPLE_KEYS, grads_of
from test_torch_train import (WORLD, make_env, make_pair, named, tiny_cfg,
                              train_test_setup)  # noqa: F401 (autouse fixture)
from test_torch_train_grads import assert_grads_close
from vln_hamt_torch.agents.agent import HAMTAgent
from vln_hamt_torch.configs import HAMTConfig
from vln_hamt_torch.data.fixtures import make_synthetic_world
from vln_hamt_torch.env import ObsSpec, R2RNavEnv
from vln_hamt_torch.run import finetune


def port_agent(table=True, **kw):
    """A port agent from seed 0 over the tiny world."""
    world = make_synthetic_world(**WORLD)
    cfg = tiny_cfg(HAMTConfig, world, **kw)
    agent = HAMTAgent(cfg, make_env(R2RNavEnv, ObsSpec, world, cfg), seed=0, device="cpu")
    if table:
        agent.enable_feature_table()
    return agent


def test_host_and_device_sampling_rollouts_agree():
    """Two agents of one seed, dropout off, sample the same batch from the
    same action generator state, one on the host loop, one on the device:
    the same actions, live masks, node rows and bootstrap mask, rewards
    within 1e-5, logits within 2e-4."""
    host, dev = port_agent(), port_agent()
    _, hx = host.interactive_rollout("sample", record_for_replay=True)
    ins = dev._device_rollout_args()
    with torch.no_grad():
        dep, dx = dev._ensure_device_rollout_fn()(
            ins["txt_ids"], ins["txt_mask"], dev._feat_table, dev._nav_tables,
            ins["start_node"], ins["start_view"], ins["offs"], ins["task_inputs"],
            policy="sample", compute_rewards=True, generator=dev.action_rng)
    hep = hx["ep"]
    for k in ("txt_ids", "node_idx", "view_index", "cand_point", "actions", "step_mask",
              "final_node_idx", "final_view_index", "final_cand_point"):
        np.testing.assert_array_equal(hep[k].numpy(), dep[k].numpy(), err_msg=k)
    for k in ("masks", "bootstrap_mask"):
        np.testing.assert_array_equal(hx[k].numpy(), dx[k].numpy(), err_msg=k)
    np.testing.assert_allclose(hx["rewards"].numpy(), dx["rewards"].numpy(), rtol=0,
                               atol=REWARD_ATOL)
    t_used = hx["rollout_logits"].shape[0]
    assert t_used >= 2 and dep["step_mask"][:, :t_used].any(dim=0).all()
    assert_logits_close(hx["rollout_logits"], dx["rollout_logits"][:t_used], "logits")
    # the draws differ from an argmax rollout's somewhere
    _, gx = port_agent().interactive_rollout("argmax", record_for_replay=True)
    assert not torch.equal(gx["ep"]["actions"], hep["actions"])


@pytest.mark.parametrize("use_device,table", [(False, True), (True, True), (False, False)],
                         ids=["host", "device", "host_no_table"])
def test_replay_draws_the_rollouts_dropout(use_device, table):
    """Dropout on: the episode forward from the rollout's starting
    dropout state gives the rollout's recorded logits within 2e-4 (JAX
    tests/test_agent.py::test_rl_replay_matches_rollout_logits); from
    the state after the rollout, other logits. The update's loss replays
    so, after the IL episode, and leaves the streams after the IL
    episode's draws."""
    agent = port_agent(table=table, dropout=True)
    il_ep = agent._ep_to_device(agent.env.teacher_episode())  # the update's host order
    ep, ex, start = agent._sample_for_replay(use_device)
    after = agent.dropout_rng.get_state()
    rec = ex["rollout_logits"]
    with torch.no_grad():
        agent.dropout_rng.set_state(start)
        replay = agent.episode_forward(ep, agent._feat_table).logits[: rec.shape[0]]
        agent.dropout_rng.set_state(after)
        other = agent.episode_forward(ep, agent._feat_table).logits[: rec.shape[0]]
    assert_logits_close(replay, rec, "replayed logits")
    fin = torch.isfinite(rec)
    assert (other[fin] - rec[fin]).abs().max() > 1e-2

    agent.dropout_rng.set_state(after)
    forward, calls = agent.episode_forward, []

    def spy(*args):
        out = forward(*args)
        calls.append((out.logits.detach(), agent.dropout_rng.get_state()))
        return out

    agent.episode_forward = spy
    agent._replay_sample_loss(il_ep, ep, ex, start)
    (_, after_il), (replayed, _) = calls
    assert_logits_close(replayed[: rec.shape[0]], rec, "the update's replayed logits")
    assert all(torch.equal(x, y) for x, y in zip(agent.dropout_rng.get_state(), after_il))


def test_replay_sgd_step_matches_jax(tiny_world):
    """One rollout-then-replay SGD step (dropout off) on the argmax
    host-loop rollout against the JAX _il_rl_update_fn on its own
    host-loop rollout of the same batch: the episode and rewards, the
    loss and its parts, every model and critic gradient, and every
    parameter after the step. At lr 1 the JAX step's parameter change
    is its gradient after the global-norm clip at 40 (the model's), so
    the port's gradients are held against it under the port's clip
    factor."""
    lr = 1.0
    jagent, agent = make_pair(tiny_world, fix=False, optim="sgd", lr=lr)
    jil = jagent._ep_to_device(jagent.env.teacher_episode())
    _, jex = jagent.interactive_rollout("argmax", jax.random.PRNGKey(0), deterministic=True,
                                        record_for_replay=True)
    st = jagent.state
    params, cparams, _, _, jloss, jaux = jagent._il_rl_update(
        st.params, st.cparams, st.opt_state, st.copt_state, jil, jax.random.PRNGKey(1),
        agent.cfg.train.ml_weight, jex["ep"], jex["rewards"], jex["masks"],
        jex["bootstrap_mask"], jax.random.PRNGKey(2), jagent._feat_table)

    il_ep = agent._ep_to_device(agent.env.teacher_episode())
    start = agent.dropout_rng.get_state()
    _, ex = agent.interactive_rollout("argmax", record_for_replay=True)
    for k in ("actions", "step_mask", "node_idx", "final_node_idx"):
        np.testing.assert_array_equal(ex["ep"][k].numpy(), np.asarray(jex["ep"][k]), err_msg=k)
    np.testing.assert_array_equal(ex["bootstrap_mask"].numpy(),
                                  np.asarray(jex["bootstrap_mask"]))
    np.testing.assert_allclose(ex["rewards"].numpy(), np.asarray(jex["rewards"]),
                               rtol=REWARD_RTOL, atol=REWARD_ATOL)
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
        for k, v in module.state_dict().items():
            np.testing.assert_allclose(v.numpy(), want[k], atol=1e-5, rtol=0, err_msg=k)


@pytest.mark.parametrize("table", [True, False], ids=["table", "no_table"])
def test_train_iteration_sample_replays(table):
    """train_iteration("sample") with dropout on through the replay: with
    the table once both the merged and the fused update are off (a
    device rollout), without it always (a host-loop rollout). Finite
    losses under the JAX package's keys, the parameters move, and two
    agents of one seed give the same losses."""
    runs = []
    for _ in range(2):
        agent = port_agent(table=table, dropout=True)
        agent.merged_sample_update = agent.fused_sample_update = False
        w0 = agent.model.next_action.net[0].weight.detach().clone()
        runs.append([agent.train_iteration("sample") for _ in range(2)])
        assert not torch.equal(w0, agent.model.next_action.net[0].weight)
    for out in runs[0]:
        assert set(out) == SAMPLE_KEYS
        assert all(np.isfinite(v) for v in out.values())
        assert out["total_actions"] >= agent.cfg.train.batch_size
    assert runs[0] == runs[1]


def test_cli_no_feat_table_on_cpu(tmp_path):
    """--no_feat_table trains with sample feedback (the host-loop rollout,
    then the replay) and evaluates on the packed evaluator, to its
    metrics record."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        best = finetune.main(["--task", "r2r", "--synthetic", "--tiny", "--cpu",
                              "--no_feat_table", "--iters", "2", "--log_every", "2",
                              "--output_dir", str(tmp_path)])
    finally:
        torch.set_num_threads(prev)
    assert best["iter"] == 2 and 0.0 <= best["sr"] <= 100.0
    logged = (tmp_path / "metrics.jsonl").read_text()
    assert '"eps_per_sec"' in logged and '"val_unseen/sr"' in logged
