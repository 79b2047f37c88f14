"""The port's IL training slice against the JAX package: losses and the
optimizers; and, on the port alone, dropout streams, checkpoints and the
training CLI. The episode forward and IL gradients are in
tests/test_torch_train_grads.py, the updates in
tests/test_torch_train_updates.py; both import this module's set-up (a
JAX agent and a port agent on the same weights and episodes). Tiny
sizes, one thread."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import vln_hamt_tpu.agents.agent as jax_agent_module
from vln_hamt_tpu.agents import losses as jl
from vln_hamt_tpu.agents.agent import HAMTAgent as JaxAgent
from vln_hamt_tpu.agents.agent import make_optimizer as jax_make_optimizer
from vln_hamt_tpu.configs import HAMTConfig as JaxHAMTConfig
from vln_hamt_tpu.env import ObsSpec as JaxObsSpec
from vln_hamt_tpu.env import R2RNavEnv as JaxEnv
from vln_hamt_tpu.models.hamt import Critic as JaxCritic
from vln_hamt_tpu.models.hamt import HAMT as JaxHAMT
from vln_hamt_tpu.models.hamt import init_hamt_params
from vln_hamt_torch.agents import losses as tl
from vln_hamt_torch.agents.agent import HAMTAgent
from vln_hamt_torch.agents.optim import OptaxOptimizer
from vln_hamt_torch.configs import HAMTConfig
from vln_hamt_torch.data.fixtures import make_synthetic_world
from vln_hamt_torch.env import ObsSpec, R2RNavEnv
from vln_hamt_torch.models.convert import critic_params_from_flax, params_from_flax
from vln_hamt_torch.models.layers import DropoutRNG, set_dropout_rng
from vln_hamt_torch.run import finetune


# ---------------------------------------------------------------- set-up
WORLD = dict(num_scans=1, nodes_per_scan=12, num_items=8, feat_dim=32, seed=1)
NO_DROPOUT = {"hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0,
              "feat_dropout": 0.0, "pred_head_dropout_prob": 0.0, "critic_dropout": 0.0}
# gradients: each tensor within 1e-3 of its own largest entry (fp32
# sums in other orders on both sides of the episode), plus 1e-6 for
# gradients that are zero in exact arithmetic and rounding noise here
# (SHIFT_ONLY below)
GRAD_REL, GRAD_ATOL = 1e-3, 1e-6


@functools.lru_cache(maxsize=None)
def _jitted_init(mcfg, views, num_ob_tokens, instr_len, hist_len):
    return jax.jit(lambda rng: init_hamt_params(mcfg, rng, views, num_ob_tokens, instr_len,
                                                hist_len)[2:])


def _fast_init_hamt_params(mcfg, rng, views=36, num_ob_tokens=51, instr_len=8, hist_len=4):
    """init_hamt_params under jit: the same parameters, in a third of the
    time of the eager trace on the CPU."""
    params, cparams = _jitted_init(mcfg, views, num_ob_tokens, instr_len, hist_len)(rng)
    return JaxHAMT(mcfg), JaxCritic(mcfg), params, cparams


@pytest.fixture(autouse=True)
def train_test_setup(monkeypatch):
    """One torch thread, and the JAX agents' parameters initialized
    under jit (test modules import this fixture)."""
    monkeypatch.setattr(jax_agent_module, "init_hamt_params", _fast_init_hamt_params)
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def tiny_cfg(cls, world, fix=True, dropout=False, optim="adamw", lr=1e-3, no_lang_ca=False,
             max_action_len=6):
    feat_dim = world.feat_db.feat_dim
    max_deg = max(g.max_degree for g in world.graphs.values())
    model = {"hidden_size": 64, "num_attention_heads": 4, "intermediate_size": 128,
             "num_l_layers": 2, "num_x_layers": 2, "num_h_pano_layers": 1,
             "image_feat_size": feat_dim, "vocab_size": 30522, "max_action_steps": 20,
             "max_position_embeddings": 64, "fix_lang_embedding": fix,
             "fix_hist_embedding": fix, "no_lang_ca": no_lang_ca}
    if not dropout:
        model.update(NO_DROPOUT)
    return cls().replace(
        model=model,
        env={"max_action_len": max_action_len, "max_instr_len": 24, "max_candidates": max_deg,
             "image_feat_size": feat_dim},
        train={"batch_size": 3, "lr": lr, "optim": optim, "feedback": "teacher"},
    )


def make_env(env_cls, spec_cls, world, cfg):
    spec = spec_cls(max_candidates=cfg.env.max_candidates,
                    image_feat_size=cfg.env.image_feat_size)
    return env_cls(world.graphs, world.feat_db, world.instr_data, spec,
                   batch_size=cfg.train.batch_size, max_instr_len=cfg.env.max_instr_len,
                   max_action_len=cfg.env.max_action_len, seed=0)


def make_pair(tiny_world, **kw):
    """A JAX agent and a port agent (CPU) with the JAX agent's weights,
    each over its own package's copy of the tiny world, both in
    feature-table mode."""
    world = make_synthetic_world(**WORLD)
    jcfg, cfg = tiny_cfg(JaxHAMTConfig, tiny_world, **kw), tiny_cfg(HAMTConfig, world, **kw)
    jagent = JaxAgent(jcfg, make_env(JaxEnv, JaxObsSpec, tiny_world, jcfg), seed=0)
    jagent.enable_feature_table()
    agent = HAMTAgent(cfg, make_env(R2RNavEnv, ObsSpec, world, cfg), seed=0, device="cpu")
    agent.load_flax_params(jax.tree.map(np.asarray, jagent.state.params),
                           jax.tree.map(np.asarray, jagent.state.cparams))
    agent.enable_feature_table()
    return jagent, agent


def named(tree, cfg=None):
    """flax tree (params, grads or moments) -> port names."""
    tree = jax.tree.map(np.asarray, tree)
    return params_from_flax(tree, cfg) if cfg is not None else critic_params_from_flax(tree)


# parameters whose IL gradient is zero in exact arithmetic, because a
# softmax ignores a shift of all its inputs: the key biases of every
# attention, and the action head's LayerNorm and output biases (they
# shift every logit alike)
SHIFT_ONLY = (".key.bias", "next_action.net.2.bias", "next_action.net.4.bias")


def assert_params_close(agent, jagent, atol, noise=(), noise_atol=None):
    """Parameters within ``atol``; those named in ``noise`` within
    ``noise_atol`` instead."""
    got = {k: v.detach().numpy() for k, v in agent.model.state_dict().items()}
    want = named(jagent.state.params, agent.cfg.model)
    for k in want:
        tol = noise_atol if k in noise else atol
        np.testing.assert_allclose(got[k], want[k], atol=tol, rtol=0, err_msg=k)


# --------------------------------------------------------------- losses
def test_losses_match_jax():
    rng = np.random.default_rng(0)
    t, b, n = 5, 3, 7
    logits = rng.standard_normal((t, b, n)).astype(np.float32)
    logits[:, :, 5:] = -np.inf  # masked actions
    logits[2, 1, 0] = -np.inf
    targets = rng.integers(0, 5, (t, b)).astype(np.int32)
    targets[3:, 0] = tl.IGNORE_ID
    targets[2, 1] = 1
    actions = rng.integers(0, 5, (t, b)).astype(np.int32)
    actions[2, 1] = 1
    values = rng.standard_normal((t, b)).astype(np.float32)
    rewards = rng.standard_normal((t, b)).astype(np.float32)
    masks = (rng.random((t, b)) < 0.8).astype(np.float32)
    last = rng.standard_normal(b).astype(np.float32)
    close = lambda a, w: np.testing.assert_allclose(np.asarray(a), np.asarray(w),
                                                    rtol=1e-5, atol=1e-6)

    tlog = torch.from_numpy(logits).requires_grad_()
    j = jnp.asarray(logits)
    got, want = tl.masked_log_softmax(tlog), jl.masked_log_softmax(j)
    assert np.array_equal(np.isfinite(got.detach().numpy()), np.isfinite(np.asarray(want)))
    fin = np.isfinite(np.asarray(want))
    close(got.detach().numpy()[fin], np.asarray(want)[fin])
    close(tl.il_loss(tlog, torch.from_numpy(targets)).item(),
          jl.il_loss(j, jnp.asarray(targets)))

    # entropy: the value, and NaN-free gradients at -inf logits
    ent = tl.entropy_from_logits(tlog)
    close(ent.detach().numpy(), jl.entropy_from_logits(j))
    (g_ent,) = torch.autograd.grad(ent.sum(), tlog)
    jg_ent = jax.grad(lambda x: jl.entropy_from_logits(x).sum())(j)
    assert np.isfinite(g_ent.numpy()).all()
    close(g_ent.numpy(), jg_ent)

    close(tl.discounted_returns(torch.from_numpy(rewards), torch.from_numpy(masks),
                                torch.from_numpy(last), 0.9).numpy(),
          jl.discounted_returns(jnp.asarray(rewards), jnp.asarray(masks),
                                jnp.asarray(last), 0.9))
    for normalize in ("total", "batch", "none"):
        tv = torch.from_numpy(values).requires_grad_()
        loss, aux = tl.a2c_loss(tlog, torch.from_numpy(actions), tv, torch.from_numpy(rewards),
                                torch.from_numpy(masks), torch.from_numpy(last), 0.9, 0.01,
                                normalize)
        gl, gv = torch.autograd.grad(loss, (tlog, tv))
        fn = lambda x, v: jl.a2c_loss(x, jnp.asarray(actions), v, jnp.asarray(rewards),
                                      jnp.asarray(masks), jnp.asarray(last), 0.9, 0.01,
                                      normalize)
        (jloss, jaux), (jgl, jgv) = jax.value_and_grad(fn, argnums=(0, 1), has_aux=True)(
            j, jnp.asarray(values))
        close(loss.item(), jloss)
        for key in jaux:
            close(aux[key].item(), jaux[key])
        assert np.isfinite(gl.numpy()).all()
        close(gl.numpy(), jgl)
        close(gv.numpy(), jgv)
    with pytest.raises(ValueError, match="normalize"):
        tl.a2c_loss(tlog, torch.from_numpy(actions), tv, torch.from_numpy(rewards),
                    torch.from_numpy(masks), torch.from_numpy(last), 0.9, 0.01, "mean")


# ----------------------------------------------------------- optimizers
@pytest.mark.parametrize("name", ["adamw", "adam", "rms", "sgd"])
def test_make_optimizer_matches_optax(name):
    """Three steps on fixed gradients behind the global-norm clip: the
    first two clipped (norms 60 and 45 against 40), the last not; adamw
    with weight decay; a parameter with no gradient is optax's zero."""
    rng = np.random.default_rng(3)
    shapes = {"a": (5, 4), "b": (7,), "frozen": (3, 3)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    steps = []
    for norm in (60.0, 45.0, 20.0):
        g = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
        g["frozen"][:] = 0.0
        total = np.sqrt(sum((x.astype(np.float64) ** 2).sum() for x in g.values()))
        steps.append({k: x * np.float32(norm / total) for k, x in g.items()})
    wd = 0.01 if name == "adamw" else 0.0
    tx = jax_make_optimizer(name, 1e-2, wd, grad_clip=40.0)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = OptaxOptimizer(tp.values(), name, 1e-2, wd, grad_clip=40.0)
    for g in steps:
        upd, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = None if k == "frozen" else torch.from_numpy(g[k])
        opt.step()
        for k in params:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=f"{name} {k}")
    with pytest.raises(ValueError, match="unknown optimizer"):
        OptaxOptimizer(tp.values(), "lamb", 1e-2)


# ------------------------------------------------------------- dropout
def test_dropout_streams(tiny_world):
    """Train mode draws every mask and attention seed from the agent's
    generators: the same seed gives the same loss, another seed another
    loss; eval mode draws nothing."""
    world = make_synthetic_world(**WORLD)
    cfg = tiny_cfg(HAMTConfig, world, fix=False, dropout=True)
    agent = HAMTAgent(cfg, make_env(R2RNavEnv, ObsSpec, world, cfg), seed=0, device="cpu")
    agent.enable_feature_table()
    ep = agent._ep_to_device(agent.env.teacher_episode())

    def loss_with(seed, train=True):
        rng = DropoutRNG("cpu", seed)
        set_dropout_rng(agent.model, rng)
        set_dropout_rng(agent.critic, rng)
        agent.model.train(train)
        agent.critic.train(train)
        states = (rng.masks.get_state(), rng.seeds.get_state())
        with torch.no_grad():
            loss = agent._il_loss(ep, 1.0).item()
        drew = [not torch.equal(a, b) for a, b in
                zip(states, (rng.masks.get_state(), rng.seeds.get_state()))]
        return loss, drew

    a, drew_a = loss_with(5)
    b, _ = loss_with(5)
    c, _ = loss_with(6)
    e1, drew_e = loss_with(5, train=False)
    e2, _ = loss_with(6, train=False)
    assert a == b and a != c
    assert drew_a == [True, True]
    assert drew_e == [False, False] and e1 == e2 != a
    set_dropout_rng(agent.model, None)
    agent.model.train()
    with pytest.raises(RuntimeError, match="DropoutRNG"):
        agent._il_loss(ep, 1.0)


# ---------------------------------------------------- agent and the CLI
def test_save_load_round_trip(tiny_world, tmp_path):
    _, agent = make_pair(tiny_world)
    agent.train_iteration("teacher")
    agent.save(str(tmp_path / "ckpt.pt"))
    _, other = make_pair(tiny_world)
    assert other.load(str(tmp_path / "ckpt.pt"), resume_optimizer=True) == 1
    for a, b in ((agent.model, other.model), (agent.critic, other.critic)):
        for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(x, y), k
    for p, q in zip(agent.model.parameters(), other.model.parameters()):
        for key in agent.optimizer.state[p]:
            assert torch.equal(agent.optimizer.state[p][key], other.optimizer.state[q][key])
    assert other.optimizer.param_groups[0]["count"] == 1
    # a resumed agent goes on with a rollout-then-replay sample update
    # (ported from ROADMAP item A10), then packed IL (A9)
    other.fused_sample_update = False
    out = other.train_iteration("sample")
    assert np.isfinite(out["RL_loss"]) and other.step == 2
    other.enable_packed_il()
    out = other.train_iteration("teacher")
    assert out["episodes"] > 0 and other.step == 3
    assert other.optimizer.param_groups[0]["count"] == 3


def test_cli_teacher_training_on_cpu(tmp_path):
    best = finetune.main(["--task", "r2r", "--synthetic", "--tiny", "--cpu",
                          "--feedback", "teacher", "--iters", "4", "--log_every", "2",
                          "--output_dir", str(tmp_path)])
    assert 0.0 <= best["sr"] <= 100.0 and best["iter"] in (2, 4)
    lines = (tmp_path / "train.txt").read_text().splitlines()
    losses = [float(ln.split("loss=")[1].split(",")[0]) for ln in lines if "loss=" in ln]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert (tmp_path / "latest.pt").exists() and (tmp_path / "best_val_unseen.pt").exists()
