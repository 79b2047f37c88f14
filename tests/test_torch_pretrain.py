"""The port's pretraining model against the JAX package's ``HAMTPretrain``
on the same weights and batches: every task's loss, metrics and
gradients, in the ``r2r`` form (every stack trained) and the
``no_lang_ca`` form (with a history-only layer and the text stack and
history [CLS] frozen); the state dict through the JAX package's reference
converter; and the attention launches of each task's update by lanes and
shape (``run/profile_attention.py:pretrain_launch_mix``), counted through
the plain twins. Tiny sizes, dropout off, one thread; the JAX side runs
on the CPU without Pallas, as its own pretraining tests do."""

import collections
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vln_hamt_tpu.configs import ModelConfig as JaxModelConfig
from vln_hamt_tpu.models.convert import convert_reference_pretrain_state_dict
from vln_hamt_tpu.pretrain.model import HAMTPretrain as JaxHAMTPretrain
from vln_hamt_tpu.pretrain.model import init_pretrain_params
from vln_hamt_torch.configs import ModelConfig
from vln_hamt_torch.data.feature_db import build_feature_table
from vln_hamt_torch.data.fixtures import make_synthetic_world
from vln_hamt_torch.models.convert import pretrain_params_from_flax
from vln_hamt_torch.models.layers import DropoutRNG, set_dropout_rng
from vln_hamt_torch.ops import attention as tops
from vln_hamt_torch.pretrain import (TASK_NAMES, PretrainBatcher, TrajectoryDataset,
                                     init_pretrain, make_synthetic_trajectories)
from vln_hamt_torch.pretrain.model import batch_to_device
from vln_hamt_torch.run.profile_attention import pretrain_launch_mix

WORLD = dict(num_scans=1, nodes_per_scan=12, num_items=10, feat_dim=48, seed=2)
HIST, TXT, BATCH = 6, 32, 4
NO_DROPOUT = {"hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0,
              "feat_dropout": 0.0, "pred_head_dropout_prob": 0.0}
TINY = dict(hidden_size=64, num_attention_heads=4, intermediate_size=128, num_l_layers=2,
            num_x_layers=2, num_h_pano_layers=1, image_feat_size=32, image_prob_size=16,
            max_position_embeddings=64, max_action_steps=16)
FORMS = {
    "r2r": dict(fix_lang_embedding=False, fix_hist_embedding=False),
    "no_lang_ca": dict(no_lang_ca=True, num_h_layers=1, fix_lang_embedding=True,
                       fix_hist_embedding=True),
}
# losses and metrics: fp32 through the tiny model, as the other suites
LOSS_ATOL = 2e-4
# gradients: tests/test_ops_vision.py's rtol 1e-4 and atol 1e-5, the
# atol taken relative to the tensor's largest entry where that passes 1
# (the LayerNorms over the padded steps' constant inputs scale some
# gradients by up to 1/sqrt(1e-12))
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5


def model_kwargs(form, dropout=False):
    return {**TINY, **FORMS[form], **({} if dropout else NO_DROPOUT)}


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=None)
def jax_params(form):
    """A JAX HAMTPretrain and its params (init under jit)."""
    jcfg = JaxModelConfig(**model_kwargs(form))
    params = jax.jit(lambda r: init_pretrain_params(jcfg, r, max_hist_len=HIST,
                                                    instr_len=TXT)[1])(jax.random.PRNGKey(0))
    return JaxHAMTPretrain(jcfg), jax.tree.map(np.asarray, params)


def port_model(form, params=None, dropout=False):
    cfg = ModelConfig(**model_kwargs(form, dropout))
    model = init_pretrain(cfg, seed=0)
    if params is not None:
        model.load_state_dict({k: torch.from_numpy(v) for k, v in
                               pretrain_params_from_flax(params, cfg).items()}, strict=True)
    set_dropout_rng(model, DropoutRNG("cpu", 0))
    return cfg, model


@pytest.fixture(scope="module")
def batcher():
    w = make_synthetic_world(**WORLD)
    ds = TrajectoryDataset(make_synthetic_trajectories(w), w.graphs, w.feat_db,
                           image_feat_size=32, image_prob_size=16, max_txt_len=TXT,
                           max_hist_len=HIST)
    return PretrainBatcher(ds, seed=1, vocab_mask_range=(1000, 2000))


def assert_grads_close(got, want):
    assert got.keys() == want.keys()
    for k in want:
        scale = max(1.0, float(np.abs(want[k]).max()))
        np.testing.assert_allclose(got[k], want[k], rtol=GRAD_RTOL, atol=GRAD_ATOL * scale,
                                   err_msg=k)


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("task", TASK_NAMES)
def test_task_loss_and_gradients_match_jax(batcher, form, task):
    """The task's loss, its metrics and every parameter's gradient against
    jax.value_and_grad of the JAX model on the same batch; a wrap-padded
    validation batch (ex_valid) too."""
    jmodel, params = jax_params(form)
    cfg, model = port_model(form, params)
    batch = batcher.batch(task, BATCH)
    for valid in (None, np.arange(BATCH) < BATCH - 1):
        b = dict(batch) if valid is None else {**batch, "ex_valid": valid}
        (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
            lambda p, bb: jmodel.apply({"params": p}, bb, task, deterministic=True),
            has_aux=True))(params, {k: jnp.asarray(v) for k, v in b.items()})
        model.train()
        model.zero_grad(set_to_none=True)
        loss, aux = model(batch_to_device(b, "cpu"), task)
        loss.backward()
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=0, atol=LOSS_ATOL)
        assert aux.keys() == jaux.keys()
        for k in jaux:
            np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=0, atol=LOSS_ATOL,
                                       err_msg=k)
        want = pretrain_params_from_flax(jax.tree.map(np.asarray, jgrads), cfg)
        got = {k: (p.grad.numpy() if p.grad is not None else np.zeros(p.shape, np.float32))
               for k, p in model.named_parameters()}
        assert_grads_close(got, want)


@pytest.mark.parametrize("form", list(FORMS))
def test_state_dict_is_a_reference_pretrain_checkpoint(form):
    """The port's state dict, read by the JAX package's converter of
    reference MultiStepNavCMTPreTraining checkpoints, gives back the flax
    params it came from, and loads strictly into the port's model."""
    _, params = jax_params(form)
    cfg, model = port_model(form, params)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    assert set(sd) == set(pretrain_params_from_flax(params, cfg))
    assert not any(k.startswith("bert.next_action") for k in sd)
    assert "mlm_head.predictions.decoder.weight" not in sd  # tied to the word embeddings
    back = convert_reference_pretrain_state_dict(sd)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=jax.tree_util.keystr(path))


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


@pytest.mark.parametrize("form,index_mode,cand", [
    ("r2r", False, False), ("r2r", True, False), ("no_lang_ca", False, False),
    ("no_lang_ca", True, True)], ids=["r2r-features", "r2r-index", "no_lang_ca-features",
                                      "no_lang_ca-index-cand_first"])
def test_launch_mix_counts_every_pretraining_attention(counted, form, index_mode, cand):
    """Each task's update, with production dropout, runs exactly the
    attentions of pretrain_launch_mix, forward and backward (with the
    candidate-first layout of the rxr preset too, whose width SpRel
    does not take)."""
    w = make_synthetic_world(**WORLD)
    ds = TrajectoryDataset(make_synthetic_trajectories(w), w.graphs, w.feat_db,
                           image_feat_size=32, image_prob_size=16, max_txt_len=TXT,
                           max_hist_len=HIST, ob_cand_pano_view=cand, ob_cand_extra=8)
    table = None
    if index_mode:
        table, offsets = build_feature_table(w.graphs, w.feat_db)
        table = torch.from_numpy(table)
        ds.set_feat_offsets(offsets)
    batcher = PretrainBatcher(ds, seed=1, vocab_mask_range=(1000, 2000))
    cfg, model = port_model(form, dropout=True)
    model.train()
    for task in TASK_NAMES:
        loss, _ = model(batch_to_device(batcher.batch(task, BATCH), "cpu"), task, table)
        loss.backward()
        fwd, bwd = pretrain_launch_mix(cfg, task, BATCH, TXT, HIST, ds.ob_width)
        got = {k: +v for k, v in counted.items()}
        assert got == {"fwd": fwd, "bwd": bwd}, task
        for v in counted.values():
            v.clear()
