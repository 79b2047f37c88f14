"""Packed IL in the port against the JAX package: the copied stream gives
the JAX stream's packs array for array; the packed forward's logits match
the JAX package's; a packed update's gradients equal the unpacked
updates' over the same episodes (the invariant tests/test_packed_il.py
pins for the JAX package); GT/aug alternation keeps one packer per env;
and the packed update launches the attentions of
``run/profile_attention.py:packed_il_mix``, counted through the plain
twins. Tiny sizes, dropout off, one thread."""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import (WORLD, make_env, make_pair, tiny_cfg,
                              train_test_setup)  # noqa: F401 (autouse fixture)
from vln_hamt_tpu.agents.packing import PackedILStream as JaxPackedILStream
from vln_hamt_tpu.data.feature_db import build_feature_table as jax_build_feature_table
from vln_hamt_tpu.env import ObsSpec as JaxObsSpec
from vln_hamt_tpu.env import R2RNavEnv as JaxEnv
from vln_hamt_torch.agents.agent import HAMTAgent
from vln_hamt_torch.agents.packing import PackedILStream, unpack_episodes
from vln_hamt_torch.configs import HAMTConfig
from vln_hamt_torch.data.feature_db import build_feature_table
from vln_hamt_torch.data.fixtures import make_synthetic_world
from vln_hamt_torch.env import ObsSpec, R2RNavEnv
from vln_hamt_torch.ops import attention as tops
from vln_hamt_torch.run.profile_attention import packed_il_mix
from vln_hamt_tpu.configs import HAMTConfig as JaxHAMTConfig

# fp32 through the tiny model (as tests/test_torch_train_grads.py)
LOGIT_ATOL = 2e-4
# packed against unpacked gradients: tests/test_ops_vision.py:92-98's
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-4, 1e-5
# a horizon with room for two of the tiny world's episodes in a slot
T_PACK = 12


def packing_cfg(cls, world, **kw):
    return tiny_cfg(cls, world, max_action_len=T_PACK, **kw)


def _dropout_off_agent(world=None, **kw):
    world = world or make_synthetic_world(**WORLD)
    cfg = packing_cfg(HAMTConfig, world, **kw)
    agent = HAMTAgent(cfg, make_env(R2RNavEnv, ObsSpec, world, cfg), seed=0, device="cpu")
    agent.enable_feature_table()
    agent.enable_packed_il()
    return world, agent


def unpack(pack, t_max, stop_slot):
    """``unpack_episodes`` of the pack, after checking the cells it reads:
    each episode on one slot, contiguous, starting at an ``is_start`` cell
    with local steps 0, 1, ..."""
    for e in range(int(pack["n_episodes"])):
        where = np.argwhere((pack["ep_id"] == e) & pack["live"])
        slots = np.unique(where[:, 0])
        assert len(slots) == 1, "episode spread over slots"
        s, ts = int(slots[0]), np.sort(where[:, 1])
        assert (np.diff(ts) == 1).all() and pack["is_start"][s, ts[0]]
        np.testing.assert_array_equal(pack["local_t"][s][ts], np.arange(len(ts)))
    return unpack_episodes(pack, t_max, stop_slot)


def _to_torch(d):
    return {k: (torch.from_numpy(np.ascontiguousarray(v)).long()
                if np.asarray(v).dtype == np.int32 else torch.from_numpy(np.asarray(v)))
            for k, v in d.items()}


# ---------------------------------------------------------------- stream
def test_stream_gives_the_jax_streams_packs(tiny_world):
    """Same world, env and seed: the same packs, array for array, and the
    same episode accounting, over packs that carry leftovers across."""
    world = make_synthetic_world(**WORLD)
    cfg, jcfg = packing_cfg(HAMTConfig, world), packing_cfg(JaxHAMTConfig, tiny_world)
    env, jenv = make_env(R2RNavEnv, ObsSpec, world, cfg), make_env(JaxEnv, JaxObsSpec,
                                                                  tiny_world, jcfg)
    env.feat_offsets = build_feature_table(env.graphs, env.feat_db)[1]
    jenv.feat_offsets = jax_build_feature_table(jenv.graphs, jenv.feat_db)[1]
    stream, jstream = PackedILStream(env), JaxPackedILStream(jenv)
    assert stream.text_cap == jstream.text_cap
    for _ in range(4):
        pack, jpack = stream.next_pack(), jstream.next_pack()
        assert pack.keys() == jpack.keys()
        for k in jpack:
            assert np.asarray(pack[k]).dtype == np.asarray(jpack[k]).dtype, k
            np.testing.assert_array_equal(pack[k], jpack[k], err_msg=k)
        assert int(pack["n_episodes"]) > env.batch_size  # packing beats the batch
    assert stream.episodes_consumed == jstream.episodes_consumed


def test_stream_needs_the_feature_table():
    world = make_synthetic_world(**WORLD)
    cfg = tiny_cfg(HAMTConfig, world)
    with pytest.raises(ValueError, match="feature-table"):
        PackedILStream(make_env(R2RNavEnv, ObsSpec, world, cfg))
    agent = HAMTAgent(cfg, make_env(R2RNavEnv, ObsSpec, world, cfg), seed=0, device="cpu")
    with pytest.raises(ValueError, match="enable_feature_table"):
        agent.enable_packed_il()


# --------------------------------------------------------------- forward
@pytest.mark.parametrize("no_lang_ca", [False, True], ids=["r2r", "no_lang_ca"])
def test_packed_logits_match_jax(tiny_world, no_lang_ca):
    """The packed forward's (T, S, N) logits, every cell, against the JAX
    package's on the same weights and pack, deterministic."""
    jagent, agent = make_pair(tiny_world, no_lang_ca=no_lang_ca, max_action_len=T_PACK)
    jagent.enable_packed_il()
    agent.enable_packed_il()
    pack, jpack = agent._packer.next_pack(), jagent._packer.next_pack()
    for k in jpack:
        np.testing.assert_array_equal(pack[k], jpack[k], err_msg=k)
    assert int(pack["n_episodes"]) > agent.env.batch_size  # slots that restart
    want = np.asarray(jax.jit(lambda p, pk, table: jagent._packed_il_forward(
        p, pk, jax.random.PRNGKey(0), deterministic=True, feat_table=table))(
        jagent.state.params, jax.tree.map(jnp.asarray, jpack), jagent._feat_table))
    agent.model.eval()
    with torch.no_grad():
        got = agent._packed_il_forward(agent._pack_to_device(pack), agent._feat_table)
    assert got.dtype == torch.float32
    got = got.numpy()
    assert got.shape == want.shape == (agent.env.max_action_len, agent.env.batch_size,
                                       want.shape[2])
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], atol=LOGIT_ATOL, rtol=0)


def test_packed_logits_are_the_unpacked_episodes_logits():
    """Each packed episode's live cells carry the logits the unpacked
    episode forward gives it (the port alone; the packing claim)."""
    _, agent = _dropout_off_agent()
    pack = agent._packer.next_pack()
    t_max = agent.env.max_action_len
    ep = _to_torch(unpack(pack, t_max, agent.env.spec.stop_slot))
    agent.model.eval()
    agent.critic.eval()
    with torch.no_grad():
        packed = agent._packed_il_forward(agent._pack_to_device(pack), agent._feat_table)
        unpacked = agent.episode_forward(ep, agent._feat_table).logits
    checked = 0
    for e in range(int(pack["n_episodes"])):
        cells = np.argwhere((pack["ep_id"] == e) & pack["live"])
        for k, (s, t) in enumerate(cells[np.argsort(cells[:, 1])]):
            a, b = packed[t, s].numpy(), unpacked[k, e].numpy()
            fin = np.isfinite(b)
            np.testing.assert_array_equal(np.isfinite(a), fin)
            np.testing.assert_allclose(a[fin], b[fin], atol=1e-5, rtol=1e-5)
            checked += 1
    assert checked == int(pack["live"].sum())


# ---------------------------------------------------------------- update
@pytest.mark.parametrize("fix", [True, False], ids=["fixed_embeddings", "all_trained"])
def test_packed_update_grads_equal_unpacked(fix):
    """d(packed CE / n_episodes) equals d(unpacked _il_loss) over the same
    episodes, which divides by its batch, the episode count: the packed
    update is the same estimator."""
    _, agent = _dropout_off_agent(fix=fix)
    pack = agent._packer.next_pack()
    ep = _to_torch(unpack(pack, agent.env.max_action_len, agent.env.spec.stop_slot))
    agent.model.train()
    agent.critic.train()

    def loss_and_grads(loss_fn):
        agent.model.zero_grad(set_to_none=True)
        loss = loss_fn()
        loss.backward()
        return loss.item(), {k: p.grad.clone() for k, p in agent.model.named_parameters()
                             if p.grad is not None}

    lp, gp = loss_and_grads(lambda: agent._packed_il_loss(
        agent._pack_to_device(pack), float(pack["n_episodes"]), 1.0))
    lu, gu = loss_and_grads(lambda: agent._il_loss(ep, 1.0))
    np.testing.assert_allclose(lp, lu, rtol=LOSS_RTOL)
    assert gp.keys() == gu.keys()
    for k in gu:
        np.testing.assert_allclose(gp[k].numpy(), gu[k].numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)
    if fix:
        assert "embeddings.word_embeddings.weight" not in gp


def test_agent_packed_training_alternates_envs_with_one_packer_each():
    """train_iteration('teacher') on packs: finite losses, more episodes
    per update than the batch, the episode count in the result; GT/aug
    alternation keeps one packer per env; the critic's optimizer steps
    (weight decay applies) as in the unpacked update."""
    world, agent = _dropout_off_agent()
    base = agent.env
    other = make_env(R2RNavEnv, ObsSpec, world, agent.cfg)
    other.seed = 99
    other.feat_offsets = base.feat_offsets
    counts0 = (agent.optimizer.state_dict()["param_groups"][0]["count"],
               agent.critic_optimizer.state_dict()["param_groups"][0]["count"])
    outs = []
    for j in range(4):
        agent.env = base if j % 2 == 0 else other
        outs.append(agent.train_iteration("teacher"))
    agent.env = base
    assert all(np.isfinite(o["loss"]) and isinstance(o["episodes"], int) for o in outs)
    assert sum(o["episodes"] for o in outs) > len(outs) * base.batch_size
    assert set(agent._packers) == {id(base), id(other)}
    assert (sum(p.episodes_consumed for p in agent._packers.values())
            == sum(o["episodes"] for o in outs))
    assert all(p.episodes_consumed > 0 for p in agent._packers.values())
    counts = (agent.optimizer.state_dict()["param_groups"][0]["count"],
              agent.critic_optimizer.state_dict()["param_groups"][0]["count"])
    assert counts == (counts0[0] + 4, counts0[1] + 4)
    assert isinstance(agent.train_iteration("teacher", sync=False)["loss"], torch.Tensor)


# -------------------------------------------------------------- launches
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


@pytest.mark.parametrize("fix,no_lang_ca", [(True, False), (False, False), (False, True)],
                         ids=["r2r_frozen", "all_trained", "no_lang_ca"])
def test_packed_il_mix_counts_every_attention(counted, fix, no_lang_ca):
    world = make_synthetic_world(**WORLD)
    cfg = tiny_cfg(HAMTConfig, world, fix=fix, dropout=True, no_lang_ca=no_lang_ca)
    agent = HAMTAgent(cfg, make_env(R2RNavEnv, ObsSpec, world, cfg), seed=0, device="cpu")
    agent.enable_feature_table()
    agent.enable_packed_il()
    agent.train_iteration("teacher")
    fwd, bwd = packed_il_mix(cfg, agent._packer.text_cap)
    assert counted == {"fwd": fwd, "bwd": bwd}
    assert agent._packer.text_cap != cfg.train.batch_size  # the text at lanes of its own
