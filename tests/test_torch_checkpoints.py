"""Released reference checkpoints and the port's own, against the JAX
package: both released formats (an agent save and a pretrain
``ModelSaver`` state dict) ingested by the port give exactly the tensors
of ``params_from_flax(load_reference_checkpoint(...))``, skip the same
leaves, and give the JAX model's logits; ``load`` (``--resume_file``)
round-trips with and without the optimizer states. Tiny sizes, one
thread (set-up from tests/test_torch_train.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_model import SIZES, _close, _inputs
from test_torch_train import (WORLD, make_env, make_pair, named, tiny_cfg,
                              train_test_setup)  # noqa: F401 (autouse fixture)
from vln_hamt_tpu.configs import ModelConfig as JaxModelConfig
from vln_hamt_tpu.models import convert as jconvert
from vln_hamt_tpu.models.hamt import HAMT as JaxHAMT
from vln_hamt_torch.agents.agent import HAMTAgent
from vln_hamt_torch.configs import HAMTConfig, ModelConfig
from vln_hamt_torch.data.fixtures import make_synthetic_world
from vln_hamt_torch.env import ObsSpec, R2RNavEnv
from vln_hamt_torch.models.convert import (critic_params_from_flax, load_reference_checkpoint,
                                           params_from_flax)
from vln_hamt_torch.models.hamt import init_hamt


def write_agent_ckpt(path, model, critic):
    """The layout of the reference's ``Seq2SeqCMTAgent.save``
    (agent_cmt.py:607-622): the wrapper's ``vln_bert.`` under a DDP
    ``module.`` prefix, with epoch and optimizer entries beside."""
    torch.save({
        "vln_bert": {"epoch": 3, "optimizer": {"state": {}, "param_groups": []},
                     "state_dict": {"module.vln_bert." + k: v
                                    for k, v in model.state_dict().items()}},
        "critic": {"epoch": 3, "optimizer": {"state": {}, "param_groups": []},
                   "state_dict": {"module." + k: v for k, v in critic.state_dict().items()}},
    }, path)


def write_model_saver_ckpt(path, model):
    """A pretrain ``ModelSaver`` state dict: the trunk under
    ``module.bert.``, the SAP head as top-level ``next_action.``, and
    pretraining heads with no fine-tuning twin."""
    sd = {}
    for k, v in model.state_dict().items():
        sd[("module." if k.startswith("next_action") else "module.bert.") + k] = v
    sd["module.mlm_head.predictions.bias"] = torch.zeros(7)
    sd["module.itm_head.weight"] = torch.ones(2, 3)
    torch.save(sd, path)


def covered_names(sd, flax_paths):
    """The names of ``sd`` whose tensors the JAX converter maps to a leaf
    at or below one of ``flax_paths`` (each tensor is tagged with its
    index, which the conversion carries into its leaf)."""
    names = list(sd)
    tagged = {k: np.full(tuple(sd[k].shape), i, np.float32) for i, k in enumerate(names)}
    flax = jconvert.convert_navcmt_state_dict(tagged,
                                              **jconvert._detect_navcmt_dims(tagged))
    leaves = jax.tree_util.tree_flatten_with_path(flax)[0]
    out = []
    for path, leaf in leaves:
        dotted = ".".join(str(k.key) for k in path)
        if any(dotted == p or dotted.startswith(p + ".") for p in flax_paths):
            out.append(names[int(np.asarray(leaf).flat[0])])
    return out


def assert_equal_dicts(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("fmt", ["agent", "model_saver"])
def test_ingestion_equals_jax_loader(tmp_path, fmt):
    """The port's loader gives, name for name, the tensors that the JAX
    loader's flax params map back to; the JAX model's plan logits on its
    params equal the port model's on the port's within 2e-4."""
    cfg = ModelConfig(**SIZES)
    model, critic = init_hamt(cfg, seed=3)
    with torch.no_grad():  # non-trivial [CLS] and LayerNorm terms
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())))
    path = str(tmp_path / "ref.pt")
    (write_agent_ckpt(path, model, critic) if fmt == "agent"
     else write_model_saver_ckpt(path, model))

    sd, csd = load_reference_checkpoint(path)
    jparams, jcritic = jconvert.load_reference_checkpoint(path)
    assert_equal_dicts({k: v.numpy() for k, v in sd.items()},
                       params_from_flax(jax.tree.map(np.asarray, jparams), cfg))
    if fmt == "agent":
        assert_equal_dicts({k: v.numpy() for k, v in csd.items()},
                           critic_params_from_flax(jax.tree.map(np.asarray, jcritic)))
    else:
        assert csd is None and jcritic is None

    fresh, _ = init_hamt(cfg, seed=9)
    fresh.load_state_dict(sd, strict=True)
    fresh.eval()
    x = _inputs()
    j = {k: jnp.asarray(v) for k, v in x.items()}
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    jm = JaxHAMT(JaxModelConfig(**SIZES))
    apply = lambda method, *a: jm.apply({"params": jparams}, *a, method=method)
    names = ("hist_tokens", "hist_mask", "ob_img", "ob_ang", "ob_nav", "ob_mask")
    with torch.no_grad():
        logits_j, _ = apply(JaxHAMT.plan, apply(JaxHAMT.encode_text, j["txt_ids"],
                                                j["txt_mask"]),
                            j["txt_mask"], *(j[n] for n in names))
        logits_t, _ = fresh.plan(fresh.encode_text(t["txt_ids"], t["txt_mask"]),
                                 t["txt_mask"], *(t[n] for n in names))
    _close(logits_t, logits_j)


@pytest.mark.parametrize("fmt", ["agent", "model_saver"])
def test_agent_init_from_reference_matches_jax(tiny_world, tmp_path, fmt):
    """Both agents, on the same weights, take a checkpoint whose dims
    differ from their config (a third text layer, another vocabulary):
    what fits loads, the same leaves are skipped on both sides, the
    results are equal, and both optimizers start fresh."""
    jagent, agent = make_pair(tiny_world, fix=False)
    agent.train_iteration("teacher")  # optimizer state to be dropped
    ref_cfg = dataclasses.replace(agent.cfg.model, num_l_layers=3, vocab_size=101)
    model, critic = init_hamt(ref_cfg, seed=5)
    path = str(tmp_path / "ref.pt")
    (write_agent_ckpt(path, model, critic) if fmt == "agent"
     else write_model_saver_ckpt(path, model))
    # the port agent trained one step: start both from the JAX weights
    agent.load_flax_params(jax.tree.map(np.asarray, jagent.state.params),
                           jax.tree.map(np.asarray, jagent.state.cparams))

    jskipped = jagent.init_from_reference(path)
    skipped = agent.init_from_reference(path)
    third = sorted(k for k in model.state_dict() if k.startswith("encoder.layer.2."))
    assert sorted(skipped) == sorted(third + ["embeddings.word_embeddings.weight"])
    # the JAX package skips flax subtrees: each covers the reference
    # tensors that its converter maps below that path
    assert sorted(jskipped) == ["embeddings.word_embeddings.embedding", "lang_layers.layer_2"]
    assert sorted(covered_names(model.state_dict(), jskipped)) == sorted(skipped)

    got = {k: v.numpy() for k, v in agent.model.state_dict().items()}
    assert_equal_dicts(got, named(jagent.state.params, agent.cfg.model))
    assert_equal_dicts({k: v.numpy() for k, v in agent.critic.state_dict().items()},
                       named(jagent.state.cparams))
    loaded = {k: v.numpy() for k, v in model.state_dict().items()}
    np.testing.assert_array_equal(got["encoder.x_layers.0.visn_output.dense.weight"],
                                  loaded["encoder.x_layers.0.visn_output.dense.weight"])
    if fmt == "agent":
        np.testing.assert_array_equal(agent.critic.state2value[0].weight.detach().numpy(),
                                      critic.state2value[0].weight.detach().numpy())
    assert agent.optimizer.param_groups[0]["count"] == 0 and not agent.optimizer.state
    assert agent.step == 1  # the step count stays, as in the JAX package


def test_reference_loader_guards(tmp_path):
    """A file with pickled objects other than tensors is refused (no
    unpickling of code); so is a state dict with no NavCMT layer, by
    init_from_pretrain too (it reads port pretraining checkpoints through
    the same loader)."""
    cfg = ModelConfig(**SIZES)
    model, critic = init_hamt(cfg, seed=3)
    path = str(tmp_path / "np.pt")
    torch.save({"vln_bert": {"state_dict": dict(model.state_dict()),
                             "extra": np.float64(1.0)}}, path)
    with pytest.raises(ValueError, match="weights_only=True"):
        load_reference_checkpoint(path)
    torch.save({"module.bert.pooler.dense.weight": torch.zeros(2, 2)}, path)
    with pytest.raises(ValueError, match="no NavCMT"):
        load_reference_checkpoint(path)
    world = make_synthetic_world(**WORLD)
    agent = HAMTAgent(tiny_cfg(HAMTConfig, world), seed=0, device="cpu")
    with pytest.raises(ValueError, match="no NavCMT"):
        agent.init_from_pretrain(path)


@pytest.mark.parametrize("resume_optimizer", [True, False], ids=["with_optimizer", "weights"])
def test_resume_round_trip(tmp_path, resume_optimizer):
    """save, then load into an agent of another seed: every parameter,
    the step and (with resume_optimizer) every moment and count equal;
    the greedy evaluation is identical."""
    world = make_synthetic_world(**WORLD)
    cfg = tiny_cfg(HAMTConfig, world, fix=False)
    agents = [HAMTAgent(cfg, make_env(R2RNavEnv, ObsSpec, world, cfg), seed=s, device="cpu")
              for s in (0, 1)]
    for a in agents:
        a.enable_feature_table()
    for _ in range(2):
        agents[0].train_iteration("teacher")
    path = str(tmp_path / "latest.pt")
    agents[0].save(path)
    assert agents[1].load(path, resume_optimizer=resume_optimizer) == 2 == agents[1].step
    for mod in ("model", "critic"):
        for (k, x), y in zip(getattr(agents[0], mod).state_dict().items(),
                             getattr(agents[1], mod).state_dict().values()):
            assert torch.equal(x, y), k
    for opt in ("optimizer", "critic_optimizer"):
        src, dst = getattr(agents[0], opt), getattr(agents[1], opt)
        if resume_optimizer:
            assert dst.param_groups[0]["count"] == src.param_groups[0]["count"] == 2
            s_state, d_state = src.state_dict()["state"], dst.state_dict()["state"]
            assert s_state.keys() == d_state.keys()
            for i in s_state:
                for key in s_state[i]:
                    assert torch.equal(s_state[i][key], d_state[i][key]), (opt, i, key)
        else:
            assert dst.param_groups[0]["count"] == 0 and not dst.state
    evals = [a.eval_split_device() for a in agents]
    assert evals[0] == evals[1]
