"""Activation recomputation in the port (``ModelConfig.remat``,
``agents/rollout.py:remat_step``) against the port without it: with
dropout on, ``full`` and ``dots`` give the same losses and post-update
parameters as remat off in every differentiated loop (the IL, merged,
fused, packed IL, replay and REVERIE IL updates), and leave the dropout
masks, attention seeds and sampled actions where remat off leaves them;
bf16 gradients stay bit-equal; the attention launches follow
``run/profile_attention.py:launch_mix(remat=True)`` (counted through the
plain twins); unknown policies raise; the CLI runs with the flags; two
tensor-parallel ranks with remat equal one rank without. The updates
against the JAX package's are in tests/test_torch_remat_jax.py. Tiny
sizes (hidden 64, 4 heads, 2 text, 1 cross-modal and 1 panorama layer,
as tests/test_remat_policy.py), one thread."""

import collections
import dataclasses

import pytest
import torch

from test_torch_parallel import assert_losses_close, assert_npz_close, run_ranks
from test_torch_train import (WORLD, make_env, tiny_cfg,
                              train_test_setup)  # noqa: F401 (autouse fixture)
from test_torch_variants import task_env, variant_cfg
from vln_hamt_torch import env as tenv
from vln_hamt_torch.agents.agent import HAMTAgent
from vln_hamt_torch.agents.reverie import ReverieAgent
from vln_hamt_torch.agents.rollout import remat_step
from vln_hamt_torch.configs import HAMTConfig, ModelConfig
from vln_hamt_torch.data import fixtures as fx
from vln_hamt_torch.env import ObsSpec, R2RNavEnv
from vln_hamt_torch.ops import attention as tops
from vln_hamt_torch.run import finetune
from vln_hamt_torch.run.profile_attention import bootstrap_mix, launch_mix, packed_il_mix

# the JAX test's tolerances (tests/test_remat_policy.py)
RTOL, ATOL = 1e-5, 1e-6
POLICIES = ("full", "dots")
UPDATES = ("il", "merged", "fused", "packed", "replay", "reverie_il")


def tiny_agent(remat=None, task="r2r", fix=True, no_lang_ca=False, dtype="float32"):
    """A port agent (CPU) at the test's size with dropout on, remat off
    or under ``remat`` (a policy), the same seed and items whatever the
    policy."""
    world = fx.make_synthetic_world(**WORLD)
    if task == "reverie":
        cfg = variant_cfg(HAMTConfig, world, task, dropout=True, fix=fix)
    else:
        cfg = tiny_cfg(HAMTConfig, world, fix=fix, dropout=True, no_lang_ca=no_lang_ca)
    cfg = cfg.replace(model={"num_x_layers": 1, "dtype": dtype, "remat": remat is not None,
                             "remat_policy": remat or "full"})
    if task == "reverie":
        agent = ReverieAgent(cfg, task_env(fx, tenv, world, task, cfg), seed=0, device="cpu")
    else:
        agent = HAMTAgent(cfg, make_env(R2RNavEnv, ObsSpec, world, cfg), seed=0, device="cpu")
    agent.enable_feature_table()
    return agent


def run_update(agent, update):
    """One update of kind ``update``; its loss."""
    if update == "packed":
        agent.enable_packed_il()
    if update in ("il", "packed", "reverie_il"):
        return agent.train_iteration("teacher")["loss"]
    agent.merged_sample_update = update == "merged"
    agent.fused_sample_update = update != "replay"
    return agent.train_iteration("sample")["loss"]


def state_after(agent):
    """The parameters, and the next draws of every stream: a dropout mask,
    an attention seed and an action noise row."""
    params = {**agent.model.state_dict(),
              **{"critic." + k: v for k, v in agent.critic.state_dict().items()}}
    draws = (agent.dropout_rng.keep(torch.zeros(64), 0.5), agent.dropout_rng.attention_seed(),
             torch.rand(8, generator=agent.action_rng))
    return {k: v.detach().clone() for k, v in params.items()}, draws


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("update", UPDATES)
def test_remat_update_equals_no_remat(update, policy):
    task = "reverie" if update == "reverie_il" else "r2r"
    want_loss = run_update(base := tiny_agent(task=task), update)
    want, want_draws = state_after(base)
    agent = tiny_agent(policy, task=task)
    got_loss = run_update(agent, update)
    got, got_draws = state_after(agent)
    assert abs(got_loss - want_loss) <= RTOL * abs(want_loss)
    assert got.keys() == want.keys()
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=RTOL, atol=ATOL, msg=k)
    # the streams stand where remat off leaves them
    assert torch.equal(got_draws[0], want_draws[0])
    assert got_draws[1] == want_draws[1]
    assert torch.equal(got_draws[2], want_draws[2])


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_bf16_gradients_bit_equal(policy):
    """bf16 under recomputation: the cached weight casts hit (the weights
    did not change between the forward and the recompute) and the bf16
    GELU's own recompute nests under the checkpoint; every gradient of an
    IL loss with dropout on is bit-equal to remat off's."""
    grads = []
    for remat in (None, policy):
        agent = tiny_agent(remat, fix=False, dtype="bfloat16")
        agent.model.train()
        agent.critic.train()
        ep = agent._ep_to_device(agent.env.teacher_episode())
        loss = agent._il_loss(ep, 1.0)
        casts = {m: m._cache for m in agent.model.modules()
                 if hasattr(m, "low_precision_params")}
        loss.backward()
        # the recompute took every cast from the cache: none was made anew
        assert all(m._cache is c and c is not None for m, c in casts.items())
        grads.append({k: p.grad for k, p in agent.model.named_parameters()
                      if p.grad is not None})
    assert grads[0].keys() == grads[1].keys()
    for k, g in grads[0].items():
        assert torch.equal(grads[1][k], g), k


@pytest.fixture
def counted(monkeypatch):
    """Calls of the plain attention forward and backward by (lanes, Lq, Lk)."""
    calls = {"fwd": collections.Counter(), "bwd": collections.Counter()}

    def counting(kind, fn):
        def wrapper(q, k, *args):
            calls[kind][(q.shape[0], q.shape[2], k.shape[2])] += 1
            return fn(q, k, *args)
        return wrapper

    monkeypatch.setattr(tops, "attention_reference", counting("fwd", tops.attention_reference))
    monkeypatch.setattr(tops, "attention_bwd_reference",
                        counting("bwd", tops.attention_bwd_reference))
    return calls


def _taken(calls, lanes=False):
    """The counts since the last call, by (lanes, Lq, Lk) or by (Lq, Lk)."""
    out = {}
    for kind, c in calls.items():
        out[kind] = +c if lanes else +collections.Counter()
        if not lanes:
            for (_, lq, lk), n in c.items():
                out[kind][(lq, lk)] += n
        c.clear()
    return out


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("fix,no_lang_ca", [(True, False), (False, False), (False, True)],
                         ids=["r2r_frozen", "all_trained", "no_lang_ca"])
def test_launch_mix_counts_recomputed_steps(counted, policy, fix, no_lang_ca):
    """Under remat each recomputed step launches its forward attentions
    again (the panorama encoder's only where it trains); the greedy
    evaluation and every backward are as without remat."""
    agent = tiny_agent(policy, fix=fix, no_lang_ca=no_lang_ca)
    cfg = agent.cfg
    plain, bwd = launch_mix(cfg)
    fwd = launch_mix(cfg, remat=True)[0]
    boot = bootstrap_mix(cfg)
    assert sum(fwd.values()) - sum(plain.values()) == cfg.env.max_action_len * (
        cfg.model.num_x_layers * (2 if no_lang_ca else 4)
        + (0 if fix else cfg.model.num_h_pano_layers))
    ins = agent._device_rollout_args(include_rewards=False)
    with torch.no_grad():
        agent._ensure_device_rollout_fn()(ins["txt_ids"], ins["txt_mask"], agent._feat_table,
                                          agent._nav_tables, ins["start_node"],
                                          ins["start_view"])
    assert _taken(counted) == {"fwd": plain, "bwd": collections.Counter()}
    agent.train_iteration("teacher")
    assert _taken(counted) == {"fwd": fwd, "bwd": bwd}
    agent.merged_sample_update = True
    agent.train_iteration("sample")
    assert _taken(counted) == {"fwd": fwd + boot, "bwd": bwd}
    agent.merged_sample_update = False
    agent.train_iteration("sample")
    assert _taken(counted) == {"fwd": fwd + fwd + boot, "bwd": bwd + bwd}
    agent.fused_sample_update = False  # the replay: its rollout without gradient
    agent.train_iteration("sample")
    assert _taken(counted) == {"fwd": plain + fwd + fwd + boot, "bwd": bwd + bwd}
    agent.enable_packed_il()
    agent.train_iteration("teacher")
    pfwd, pbwd = packed_il_mix(cfg, agent._packer.text_cap, remat=True)
    assert _taken(counted, lanes=True) == {"fwd": pfwd, "bwd": pbwd}


def test_unknown_policy_raises():
    cfg = dataclasses.replace(ModelConfig(), remat=True, remat_policy="bogus")
    with pytest.raises(ValueError, match="remat_policy"):
        remat_step(lambda c, x: (c, x), cfg)
    off = dataclasses.replace(cfg, remat=False)
    step = lambda c, x: (c, x)  # noqa: E731
    assert remat_step(step, off) is step


def test_cli_flag(tmp_path):
    """--remat --remat_policy dots through the fine-tuning CLI (tiny, CPU)."""
    finetune.main(["--task", "r2r", "--synthetic", "--tiny", "--remat", "--remat_policy",
                   "dots", "--feedback", "teacher", "--iters", "2", "--log_every", "2",
                   "--cpu", "--output_dir", str(tmp_path / "run")])


def test_tensor_parallel_remat_matches_one_rank(tmp_path):
    """Two model ranks (gloo) under --remat full recompute each step's
    row-parallel all-reduces in backward, in the same order on both
    ranks: the IL and merged updates' losses, the gathered gradients and
    the parameters equal one rank's without remat."""
    argv = ("--steps", "il,merged", "--grad_clip", "0.05")
    want = run_ranks(tmp_path, "one", 0, *argv, "--grads_out", str(tmp_path / "g1.npz"),
                     "--params_out", str(tmp_path / "p1.npz"))
    got = run_ranks(tmp_path, "tp", 2, *argv, "--model_shards", "2", "--remat", "full",
                    "--grads_out", str(tmp_path / "g2.npz"),
                    "--params_out", str(tmp_path / "p2.npz"))
    assert_losses_close(got, want)
    assert_npz_close(tmp_path / "g2.npz", tmp_path / "g1.npz")
    assert_npz_close(tmp_path / "p2.npz", tmp_path / "p1.npz")
