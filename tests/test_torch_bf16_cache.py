"""The bf16 weight cache and GELU of ``models/layers.py``: the IL loss and
every gradient bit-identical to a Linear that casts its weight and bias
on every call and a GELU that saves its fp32 chain; fewer bytes saved
for backward than fp32; and no stale copy after an optimizer step, a
checkpoint load or a reference initialization. Tiny sizes, one thread,
the port alone."""

import math

import pytest
import torch
import torch.nn.functional as F

from test_torch_train import (WORLD, make_env, tiny_cfg,
                              train_test_setup)  # noqa: F401 (autouse fixture)
from vln_hamt_torch.agents.agent import HAMTAgent
from vln_hamt_torch.configs import HAMTConfig
from vln_hamt_torch.data.fixtures import make_synthetic_world
from vln_hamt_torch.env import ObsSpec, R2RNavEnv
from vln_hamt_torch.models import layers
from vln_hamt_torch.models.layers import Intermediate, Linear

def per_call_forward(self, x):
    """The Linear of the port before the cache: input, weight and bias
    cast on every call."""
    dt = self.compute_dtype
    return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


def fp32_chain_gelu(x):
    """The GELU of the port before it saved its bf16 input: the fp32 chain
    under autograd."""
    xf = x.float()
    return (xf * 0.5 * (1.0 + torch.erf(xf / math.sqrt(2.0)))).to(x.dtype)


def make_agent(world, dtype="bfloat16", seed=0, **kw):
    cfg = tiny_cfg(HAMTConfig, world, **kw).replace(model={"dtype": dtype})
    agent = HAMTAgent(cfg, make_env(R2RNavEnv, ObsSpec, world, cfg), seed=seed, device="cpu")
    agent.enable_feature_table()
    return agent


def il_loss_and_grads(agent):
    agent.model.train()
    agent.critic.train()
    ep = agent._ep_to_device(agent.env.teacher_episode())
    loss = agent._il_loss(ep, 1.0)
    loss.backward()
    return loss.detach(), {k: p.grad for k, p in agent.model.named_parameters()
                           if p.grad is not None}


@pytest.mark.parametrize("t_max", [1, 6], ids=["T1", "T6"])
def test_bf16_il_bit_identical_to_per_call_cast(monkeypatch, t_max):
    """With every stack trained and dropout on, each Linear runs T times
    per loss and the cross-modal attention twice per step: the loss and
    every gradient equal, to the bit, those of the per-call cast (whose
    gradients sum in fp32 in .grad), on the same seeds."""
    world = make_synthetic_world(**WORLD)
    loss, grads = il_loss_and_grads(make_agent(world, fix=False, dropout=True,
                                               max_action_len=t_max))
    monkeypatch.setattr(Linear, "forward", per_call_forward)
    monkeypatch.setitem(layers.ACT2FN, "gelu", fp32_chain_gelu)
    ref = make_agent(world, fix=False, dropout=True, max_action_len=t_max)
    assert all(m.act is fp32_chain_gelu for m in ref.model.modules()
               if isinstance(m, Intermediate))
    want_loss, want = il_loss_and_grads(ref)
    assert torch.equal(loss, want_loss)
    assert grads.keys() == want.keys() and len(want) > 100
    for k in want:
        assert grads[k].dtype == torch.float32, k
        assert torch.equal(grads[k], want[k]), k


def saved_bytes(agent) -> int:
    """Bytes of the distinct storages one IL loss saves for backward,
    parameters' own storages left out."""
    params = {p.untyped_storage().data_ptr() for p in agent.model.parameters()}
    seen = {}

    def pack(t):
        st = t.untyped_storage()
        if st.data_ptr() not in params:
            seen[st.data_ptr()] = st.nbytes()
        return t

    agent.model.train()
    ep = agent._ep_to_device(agent.env.teacher_episode())
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        agent._il_loss(ep, 1.0)
    return sum(seen.values())


def test_bf16_saves_fewer_bytes_than_fp32(monkeypatch):
    """One IL loss with every stack trained saves fewer bytes for backward
    in bf16 than in fp32, and fewer than with the per-call cast."""
    world = make_synthetic_world(**WORLD)
    fp32 = saved_bytes(make_agent(world, dtype="float32", fix=False))
    bf16 = saved_bytes(make_agent(world, fix=False))
    monkeypatch.setattr(Linear, "forward", per_call_forward)
    monkeypatch.setitem(layers.ACT2FN, "gelu", fp32_chain_gelu)
    per_call = saved_bytes(make_agent(world, fix=False))
    assert bf16 < per_call and bf16 < fp32, (bf16, per_call, fp32)


def greedy_logits(agent):
    """The first batch's greedy rollout logits, the env rewound."""
    agent.env.reset_epoch(shuffle=False)
    ins = agent._device_rollout_args(include_rewards=False)
    agent.model.eval()
    agent.critic.eval()
    with torch.no_grad():
        _, ex = agent._ensure_device_rollout_fn()(
            ins["txt_ids"], ins["txt_mask"], agent._feat_table, agent._nav_tables,
            ins["start_node"], ins["start_view"])
    return ex["rollout_logits"]


def assert_same_as_fresh(agent, world):
    """A fresh agent of another seed holding ``agent``'s weights gives its
    greedy logits to the bit."""
    fresh = make_agent(world, seed=5)
    fresh.model.load_state_dict(agent.model.state_dict())
    fresh.critic.load_state_dict(agent.critic.state_dict())
    assert torch.equal(greedy_logits(agent), greedy_logits(fresh))


def test_no_stale_bf16_weights(tmp_path):
    """Evaluate (the cache fills), then change the weights by an
    optimizer step, a checkpoint load and a reference initialization: each
    time the next evaluation is a fresh agent's on the new weights."""
    world = make_synthetic_world(**WORLD)
    agent = make_agent(world, fix=False)
    before = greedy_logits(agent)
    agent.train_iteration("teacher")
    assert not torch.equal(greedy_logits(agent), before)
    assert_same_as_fresh(agent, world)

    other = make_agent(world, seed=3)
    other.save(tmp_path / "other.pt")
    agent.load(tmp_path / "other.pt")
    assert torch.equal(greedy_logits(agent), greedy_logits(other))

    third = make_agent(world, seed=4)
    torch.save({"vln_bert": {"state_dict": third.model.state_dict()},
                "critic": {"state_dict": third.critic.state_dict()}}, tmp_path / "ref.pt")
    assert agent.init_from_reference(str(tmp_path / "ref.pt")) == []
    assert torch.equal(greedy_logits(agent), greedy_logits(third))
