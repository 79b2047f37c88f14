"""Each fault a cell can have, planted under the program, makes the
check's ``correct`` false: the rest of a run (set-up, window, check) runs
as it does on the card, at a tiny size on the CPU. The cells run on one
chip, so no exchange between chips exists to leave out."""

from __future__ import annotations

import torch

import vln_hamt_torch.agents.agent as agent_mod
import vln_hamt_torch.agents.optim as optim_mod
import vln_hamt_torch.agents.rollout as rollout_mod

from .helpers import run_tiny

TRAIN = ("tiny.finetune", "tiny_nolang.finetune")


def _failed(cell) -> dict:
    res, nums = run_tiny(cell)
    assert not res["correct"], nums
    return {n: v for n, (v, lim) in nums.items() if v > lim}


def test_a_step_that_leaves_the_state_unchanged(monkeypatch):
    monkeypatch.setattr(optim_mod.OptaxOptimizer, "step", lambda self, closure=None: None)
    for cell in TRAIN:
        bad = _failed(cell)
        assert "change_gap" in bad and "grad_gap" in bad


def test_adam_steps_with_its_count_stuck_at_one(monkeypatch):
    """Every step bias-corrects as the first: the first update is sound,
    the second and third are not."""
    adam = optim_mod.OptaxOptimizer._adam_family
    monkeypatch.setattr(optim_mod.OptaxOptimizer, "_adam_family",
                        lambda self, params, grads, count: adam(self, params, grads, 1))
    for cell in TRAIN:
        bad = _failed(cell)
        assert "change3_median_gap" in bad and "change_gap" not in bad


def test_adam_moments_not_carried_over(monkeypatch):
    """Every step starts from zero moments."""
    moment = optim_mod.OptaxOptimizer._moment
    monkeypatch.setattr(optim_mod.OptaxOptimizer, "_moment",
                        lambda self, p, key: moment(self, p, key).zero_())
    for cell in TRAIN:
        bad = _failed(cell)
        assert "change3_median_gap" in bad and "change_gap" not in bad


def test_a_transition_altered_in_the_window(monkeypatch):
    """After the three updates that the reference replays, the rollout
    records one lane's second pose one node off."""
    rollout = agent_mod.HAMTAgent._rollout
    calls = []

    def off(self, *args, **kwargs):
        ep, extras = rollout(self, *args, **kwargs)
        calls.append(1)
        if len(calls) > 3:
            ep["node_idx"][0, 1] += 1
        return ep, extras

    monkeypatch.setattr(agent_mod.HAMTAgent, "_rollout", off)
    for cell in TRAIN:
        calls.clear()
        assert set(_failed(cell)) == {"mismatch"}


def test_half_the_batch_left_out(monkeypatch):
    """The A2C loss over the first half of the sampled lanes alone, its
    mean over them."""
    a2c = agent_mod.a2c_loss

    def half(logits, actions, values, rewards, masks, *args, **kwargs):
        keep = torch.zeros_like(masks)
        keep[:, : masks.shape[1] // 2 + 1] = 1.0
        return a2c(logits, actions, values, rewards, masks * keep, *args, **kwargs)

    monkeypatch.setattr(agent_mod, "a2c_loss", half)
    for cell in TRAIN:
        assert "loss_gap" in _failed(cell)


def test_a_sampled_action_altered_where_it_is_drawn(monkeypatch):
    """The sampled action is the second best of the perturbed logits."""
    draw = rollout_mod.gumbel_max

    def second(logits, generator, rows=None):
        best = draw(logits, generator, rows)
        masked = logits.clone()
        masked[torch.arange(len(best)), best] = -float("inf")
        alt = torch.argmax(masked, -1)
        return torch.where(torch.isfinite(masked.max(-1).values), alt, best)

    monkeypatch.setattr(rollout_mod, "gumbel_max", second)
    for cell in TRAIN:
        bad = _failed(cell)
        assert "action_gap" in bad


def test_a_greedy_action_altered_where_it_is_chosen(monkeypatch):
    """The device rollout's greedy choice is the second best logit."""
    class Second:
        def __getattr__(self, name):
            return getattr(torch, name)

        @staticmethod
        def argmax(x, dim=None):
            return torch.topk(x, 2, dim=dim).indices.select(dim, 1)

    monkeypatch.setattr(rollout_mod, "torch", Second())
    assert "logit_gap" in _failed("tiny.eval")


def test_half_the_evaluated_items_left_out(monkeypatch):
    decode = agent_mod.HAMTAgent._decode_device_trajectories

    def half(self, env, ep, extras):
        out = decode(self, env, ep, extras)
        return out[: len(out) // 2]

    monkeypatch.setattr(agent_mod.HAMTAgent, "_decode_device_trajectories", half)
    assert "mismatch" in _failed("tiny.eval")
