"""The port's pretraining loop against the JAX package's: the optimizer
zoo stepping as optax does (at grad_accum 1 and 2, with the no-decay
masks equal through the converter), trainer updates and full-split
validation on the same batches, the HuggingFace BERT / XLM-R converters,
``--init_pretrain`` against the JAX package's pretrain -> fine-tune
graft; and, on the port alone, the pretraining CLI on the CPU feeding
fine-tuning. Tiny sizes, dropout off, one thread; the JAX side runs on
the CPU without Pallas."""

import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_pretrain import FORMS, HIST, NO_DROPOUT, TINY, TXT, WORLD, jax_params, port_model
from test_torch_train import make_pair, train_test_setup  # noqa: F401 (autouse fixture)
from vln_hamt_tpu.configs import ModelConfig as JaxModelConfig
from vln_hamt_tpu.data.feature_db import build_feature_table as jax_build_feature_table
from vln_hamt_tpu.data.fixtures import make_synthetic_world as jax_world
from vln_hamt_tpu.models import convert as jax_convert
from vln_hamt_tpu.pretrain import PretrainBatcher as JaxPretrainBatcher
from vln_hamt_tpu.pretrain import PretrainTrainer as JaxPretrainTrainer
from vln_hamt_tpu.pretrain import TrajectoryDataset as JaxTrajectoryDataset
from vln_hamt_tpu.pretrain import make_synthetic_trajectories as jax_trajectories
from vln_hamt_tpu.pretrain.model import init_pretrain_params
from vln_hamt_tpu.pretrain.optim import _no_decay_mask
from vln_hamt_tpu.pretrain.optim import build_pretrain_optimizer as jax_build_optimizer
from vln_hamt_tpu.pretrain.optim import warmup_linear_schedule as jax_warmup_linear
from vln_hamt_torch.configs import ModelConfig
from vln_hamt_torch.data.feature_db import build_feature_table
from vln_hamt_torch.data.fixtures import make_synthetic_world
from vln_hamt_torch.models.convert import (convert_hf_bert_state_dict,
                                           convert_hf_xlmr_state_dict, load_reference_checkpoint,
                                           params_from_flax, pretrain_params_from_flax)
from vln_hamt_torch.pretrain import (PretrainBatcher, PretrainTrainer, TrajectoryDataset,
                                     init_pretrain, make_synthetic_trajectories)
from vln_hamt_torch.pretrain.model import batch_to_device
from vln_hamt_torch.pretrain.optim import build_pretrain_optimizer, decay_mask
from vln_hamt_torch.pretrain.optim import warmup_linear_schedule
from vln_hamt_torch.run import finetune
from vln_hamt_torch.run import pretrain as pretrain_cli

OPTIMIZERS = ("adamw", "adam", "radam", "ralamb", "lookahead", "rangerlars")
# parameters after a step against optax's: a part in 1e4 of an update;
# for RAdam's family a part in 1e3, the float32 noise of its
# rectification on both sides (rho_t is a difference of two numbers near
# 2000), which the trust ratio scales to the weights' size
ATOL = {"adamw": 1e-6, "adam": 1e-6, "lookahead": 1e-6, "radam": 1e-5, "ralamb": 2e-5,
        "rangerlars": 2e-5}


# ------------------------------------------------------------ optimizers
def test_decay_masks_match_jax():
    """The no-decay mask (biases and LayerNorms) keyed on the port's
    reference names selects the tensors the JAX package's mask keyed on
    flax names selects."""
    _, params = jax_params("r2r")
    cfg, model = port_model("r2r", params)
    jmask = pretrain_params_from_flax(jax.tree.map(np.asarray, _no_decay_mask(params)), cfg)
    mask = decay_mask(model)
    assert mask.keys() == jmask.keys()
    for k, want in jmask.items():
        assert np.all(want == want.flat[0]), k
        assert mask[k] == bool(want.flat[0]), k
    assert not mask["bert.encoder.layer.0.attention.output.LayerNorm.weight"]
    assert not mask["mlm_head.predictions.bias"] and mask["bert.hist_embeddings.cls_token"]


class _Tiny(torch.nn.Module):
    """One of each kind of parameter the masks tell apart, and a head."""

    def __init__(self):
        super().__init__()
        self.dense = torch.nn.Linear(6, 5)
        self.LayerNorm = torch.nn.LayerNorm(5)
        self.emb = torch.nn.Embedding(7, 5)
        self.head = torch.nn.Linear(5, 3)


#: _Tiny's parameters as flax leaves: (module, leaf, transposed)
_FLAX = {"dense.weight": ("dense", "kernel", True), "dense.bias": ("dense", "bias", False),
         "LayerNorm.weight": ("LayerNorm", "scale", False),
         "LayerNorm.bias": ("LayerNorm", "bias", False),
         "emb.weight": ("emb", "embedding", False), "head.weight": ("head", "kernel", True),
         "head.bias": ("head", "bias", False)}


def _tiny_flax(tree):
    """The flax form of a _Tiny tree (kernels transposed)."""
    out = {}
    for k, (mod, leaf, t) in _FLAX.items():
        out.setdefault(mod, {})[leaf] = tree[k].T if t else tree[k]
    return out


@pytest.mark.parametrize("grad_accum", [1, 2])
@pytest.mark.parametrize("name", OPTIMIZERS)
def test_optimizers_step_as_optax(name, grad_accum):
    """14 micro-batches of random gradients (the head without one on odd
    steps, as the heads a task does not use), clip at global norm 1, the
    warmup-linear schedule, weight decay 0.01: the port's parameters
    after every step equal optax's (lookahead's fast weights; its sync
    every 6 micro-batches, RAdam's rectification from update 6)."""
    torch.manual_seed(0)
    model = _Tiny()
    named = dict(model.named_parameters())
    sched = (1e-2, 3, 20)
    tx = jax_build_optimizer(name, jax_warmup_linear(*sched), weight_decay=0.01, grad_norm=1.0,
                             grad_accum=grad_accum)
    lookahead = name in ("lookahead", "rangerlars")
    jp = _tiny_flax({k: jnp.asarray(p.detach().numpy()) for k, p in named.items()})
    if lookahead:
        jp = optax.LookaheadParams(fast=jp, slow=jax.tree.map(jnp.copy, jp))
    state = tx.init(jp)
    update = jax.jit(lambda g, s, p: (lambda u, s2: (optax.apply_updates(p, u), s2))(
        *tx.update(g, s, p)))
    opt = build_pretrain_optimizer(name, model, warmup_linear_schedule(*sched),
                                   weight_decay=0.01, grad_norm=1.0, grad_accum=grad_accum)
    rng = np.random.default_rng(0)
    for step in range(14):
        g = {k: rng.standard_normal(p.shape).astype(np.float32) for k, p in named.items()}
        idle = step % 2 == 1
        if idle:
            g["head.weight"], g["head.bias"] = np.zeros((3, 5), np.float32), np.zeros(3, np.float32)
        jp, state = update(_tiny_flax({k: jnp.asarray(v) for k, v in g.items()}), state, jp)
        for k, p in named.items():
            p.grad = None if idle and k.startswith("head.") else torch.from_numpy(g[k])
        opt.step()
        want = jax.tree.map(np.asarray, jp.fast if lookahead else jp)
        got = _tiny_flax({k: p.detach().numpy() for k, p in named.items()})
        for (path, w), gv in zip(jax.tree_util.tree_leaves_with_path(want),
                                 jax.tree.leaves(got)):
            np.testing.assert_allclose(gv, w, rtol=1e-5, atol=ATOL[name],
                                       err_msg=f"step {step} {jax.tree_util.keystr(path)}")
    assert opt.param_groups[0]["count"] == 14 // grad_accum
    jmask = _no_decay_mask(_tiny_flax({k: np.zeros(2) for k in named}))
    mask = decay_mask(model)
    assert mask == {k: jmask[mod][leaf] for k, (mod, leaf, _) in _FLAX.items()}
    assert mask == {"dense.weight": True, "dense.bias": False, "LayerNorm.weight": False,
                    "LayerNorm.bias": False, "emb.weight": True, "head.weight": True,
                    "head.bias": False}


# --------------------------------------------------------------- trainer
# parameters whose gradient is zero in exact arithmetic and rounding
# noise on both sides, because a softmax ignores a shift of all its
# inputs: the attention key biases, and the LayerNorm and output biases
# of the SAP and ITM heads; adam scales that noise up to the learning
# rate, so after the updates they are held to adam's largest step, not
# to the JAX values
SHIFT_ONLY = (".key.bias", "next_action.net.2.bias", "next_action.net.4.bias",
              "itm_head.net.2.bias", "itm_head.net.3.bias")
# "zero to rounding": no entry above this; at this size such gradients
# stay under 4e-8 and every other used parameter has an entry above 7e-4
ROUNDING = 1e-6
# adam's |m_hat / sqrt(v_hat)| over its first 8 updates (b1 0.9, b2
# 0.999) is at most 1.028, by Cauchy-Schwarz on the moment sums
ADAM_MAX_STEP = 1.03
# the trainer test's tasks: one reading the text (through the tied
# decoder), the pairs of ITM, and one reading the observation
TRAINER_TASKS = ("mlm", "itm", "sap")


def _rounding_grads(jt, t, jds, tasks):
    """The names of the parameters that some task uses (the port's
    autograd reaches them) whose gradient is zero to rounding, at the
    trainers' initial weights on one batch of each task: by the JAX
    model's gradients, and by the port's."""
    params = jax.tree.map(np.asarray, jt.params)
    jb = JaxPretrainBatcher(jds, seed=5, vocab_mask_range=(1000, 2000))
    peak, jpeak, used = {}, {}, set()
    for task in tasks:
        batch = jb.batch(task, t.batch_size)
        g = jax.jit(jax.grad(lambda p, b: jt.model.apply(
            {"params": p}, b, task, deterministic=True, feat_table=jt._feat_table)[0]))(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
        t.model.zero_grad(set_to_none=True)
        t.model(batch_to_device(batch, "cpu"), task, t._feat_table)[0].backward()
        grads = {k: p.grad.numpy() for k, p in t.model.named_parameters() if p.grad is not None}
        used |= grads.keys()
        for out, gr in ((jpeak, pretrain_params_from_flax(jax.tree.map(np.asarray, g), t.cfg)),
                        (peak, grads)):
            for k, v in gr.items():
                out[k] = max(out.get(k, 0.0), float(np.abs(v).max()))
    t.model.zero_grad(set_to_none=True)
    return ({k for k in used if jpeak[k] <= ROUNDING}, {k for k in used if peak[k] <= ROUNDING})


def _trainers(index_mode, optim="adamw", steps=40, tasks=None):
    """A JAX trainer and a port trainer (CPU) with the JAX trainer's
    weights, each over its own package's copy of the world, same seeds."""
    kwargs = {**TINY, **FORMS["r2r"], **NO_DROPOUT}
    jw, w = jax_world(**WORLD), make_synthetic_world(**WORLD)
    ds_args = dict(image_feat_size=32, image_prob_size=16, max_txt_len=TXT, max_hist_len=HIST)
    jds = JaxTrajectoryDataset(jax_trajectories(jw), jw.graphs, jw.feat_db, **ds_args)
    ds = TrajectoryDataset(make_synthetic_trajectories(w), w.graphs, w.feat_db, **ds_args)
    jtable = table = None
    if index_mode:
        jtable, offsets = jax_build_feature_table(jw.graphs, jw.feat_db)
        jds.set_feat_offsets(offsets)
        table, offsets = build_feature_table(w.graphs, w.feat_db)
        ds.set_feat_offsets(offsets)
    tasks = tasks or ("mlm", "mrc", "itm", "sap", "sar", "sprel")
    common = dict(batch_size=4, lr=1e-3, warmup_steps=2, total_steps=steps, seed=0,
                  tasks=tasks, mix_ratio=(1,) * len(tasks), optim=optim)
    jt = JaxPretrainTrainer(JaxModelConfig(**kwargs),
                            JaxPretrainBatcher(jds, seed=0, vocab_mask_range=(1000, 2000)),
                            feat_table=jtable, **common)
    t = PretrainTrainer(ModelConfig(**kwargs),
                        PretrainBatcher(ds, seed=0, vocab_mask_range=(1000, 2000)),
                        feat_table=table, device="cpu", **common)
    t.load_flax_params(jax.tree.map(np.asarray, jt.params))
    return jt, t, (jds, ds)


def test_trainer_updates_match_jax():
    """Eight scheduled updates, index-mode batches through the resident
    table, adamw with the warmup-linear schedule (the CLI's defaults at a
    tiny size): the same tasks in the same order, the same losses and
    metrics, and the same parameters after them."""
    jt, t, (jds, _) = _trainers(index_mode=True, tasks=TRAINER_TASKS)
    jnoise, noise = _rounding_grads(jt, t, jds, TRAINER_TASKS)
    assert jnoise == noise == {k for k in t.model.state_dict() if k.endswith(SHIFT_ONLY)}
    start = {k: v.clone().numpy() for k, v in t.model.state_dict().items()}
    seen = set()
    for _ in range(8):
        jtask, jloss, jaux = jt.train_step()
        task, loss, aux = t.train_step()
        loss, aux = float(loss), {k: float(v) for k, v in aux.items()}
        assert task == jtask
        seen.add(task)
        np.testing.assert_allclose(loss, jloss, rtol=0, atol=2e-4, err_msg=task)
        for k in jaux:
            np.testing.assert_allclose(aux[k], jaux[k], rtol=0, atol=2e-4, err_msg=f"{task} {k}")
    t.close()
    assert t.step == jt.state.step == 8 and seen == set(TRAINER_TASKS)
    want = pretrain_params_from_flax(jax.tree.map(np.asarray, jt.params), t.cfg)
    lr = warmup_linear_schedule(1e-3, 2, 40)
    lr_sum = sum(lr(k) for k in range(8))
    for k, v in t.model.state_dict().items():
        if k in noise:
            # adamw moves a weight by at most lr * (ADAM_MAX_STEP + 0.01 |w|)
            # per update, whatever its gradient
            bound = lr_sum * (ADAM_MAX_STEP + 0.01 * (np.abs(start[k]).max() + 1))
            for side, w in (("port", v.numpy()), ("jax", want[k])):
                assert np.abs(w - start[k]).max() <= bound, f"{side} {k}"
        else:
            np.testing.assert_allclose(v.numpy(), want[k], rtol=0, atol=5e-5, err_msg=k)


def test_validate_matches_jax():
    """Full-split validation of every task (wrap-padded last batch,
    ex_valid weights, re-seeded streams): the same numbers, the same
    example counts, and the same again on a second call."""
    jt, t, (jds, ds) = _trainers(index_mode=False)
    jb = JaxPretrainBatcher(jds, seed=9, vocab_mask_range=(1000, 2000))
    b = PretrainBatcher(ds, seed=9, vocab_mask_range=(1000, 2000))
    want, got = jt.validate(jb), t.validate(b)
    assert got.keys() == want.keys() == set(t.scheduler.tasks)
    for task in want:
        assert got[task].keys() == want[task].keys(), task
        for k in want[task]:
            np.testing.assert_allclose(got[task][k], want[task][k], rtol=0, atol=2e-4,
                                       err_msg=f"{task} {k}")
    assert got["sap"]["n"] == len(ds.traj_step_refer) and got["itm"]["n"] == len(ds.traj_refer)
    b.batch("mlm", 4)  # the stream moves; full-split validation must not care
    assert t.validate(b) == got
    t.close()


# ------------------------------------------------------ HF text encoders
def _hf_state_dict(prefix, vocab, positions, types, layers=3, d=64, inter=128, seed=0):
    """A synthetic HuggingFace encoder state dict with the real names and
    shapes (and the names a trunk does not take)."""
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    sd = {f"{prefix}.embeddings.word_embeddings.weight": r(vocab, d),
          f"{prefix}.embeddings.position_embeddings.weight": r(positions, d),
          f"{prefix}.embeddings.token_type_embeddings.weight": r(types, d),
          f"{prefix}.embeddings.LayerNorm.weight": r(d), f"{prefix}.embeddings.LayerNorm.bias": r(d),
          f"{prefix}.pooler.dense.weight": r(d, d), f"{prefix}.pooler.dense.bias": r(d)}
    for i in range(layers):
        pre = f"{prefix}.encoder.layer.{i}"
        for lin, (o, n) in {"attention.self.query": (d, d), "attention.self.key": (d, d),
                            "attention.self.value": (d, d), "attention.output.dense": (d, d),
                            "intermediate.dense": (inter, d), "output.dense": (d, inter)}.items():
            sd[f"{pre}.{lin}.weight"], sd[f"{pre}.{lin}.bias"] = r(o, n), r(o)
        for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[f"{pre}.{ln}.weight"], sd[f"{pre}.{ln}.bias"] = r(d), r(d)
    return {k: torch.from_numpy(v) for k, v in sd.items()}


@pytest.mark.parametrize("kind", ["bert", "xlmr"])
def test_hf_text_init_matches_jax(kind, tmp_path):
    """BERT (and XLM-R: its one type row duplicated, its 514-row position
    table left out) over the trunk: the port's partial state dict merged
    over a trunk equals the JAX converter's partial tree merged over the
    same trunk's flax params; the CLI's loader reads the file with
    weights_only=True and refuses a HuggingFace directory."""
    _, params = jax_params("r2r")
    cfg = ModelConfig(**{**TINY, **FORMS["r2r"]})
    if kind == "bert":
        sd = _hf_state_dict("bert", 30522, 64, 2)
        partial = convert_hf_bert_state_dict(sd, num_l_layers=2)
        jpartial = jax_convert.convert_hf_bert_state_dict(sd, num_l_layers=2)
    else:
        sd = _hf_state_dict("roberta", 30522, 514, 1)
        partial = convert_hf_xlmr_state_dict(sd, 2, max_position_embeddings=64)
        jpartial = jax_convert.convert_hf_xlmr_state_dict(sd, 2, max_position_embeddings=64)
        assert partial["embeddings.token_type_embeddings.weight"].shape == (2, 64)
        assert "embeddings.position_embeddings.weight" not in partial
    want = params_from_flax(jax_convert.merge_params(params["hamt"], jpartial), cfg)
    got = {**params_from_flax(params["hamt"], cfg), **partial}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    path = tmp_path / "hf.bin"
    torch.save(sd, path)
    loaded = pretrain_cli.load_bert_partial(str(path), cfg, kind)
    assert loaded.keys() == partial.keys()
    with pytest.raises(ValueError, match="transformers"):
        pretrain_cli.load_bert_partial(str(tmp_path), cfg, kind)


# ---------------------------------------------------------- fine-tuning
def test_init_pretrain_matches_jax_graft(tiny_world, tmp_path):
    """A port pretraining checkpoint (the JAX pretrain params through the
    converter, saved as run/pretrain.py saves) given to
    HAMTAgent.init_from_pretrain yields the fine-tuning logits and values
    of the JAX agent after pretrain_to_finetune_params (the trunk, and
    the SAP head grafted onto the action head)."""
    jagent, agent = make_pair(tiny_world, fix=False)
    mcfg = jagent.cfg.model
    pcfg = JaxModelConfig(**{**vars(mcfg), "image_prob_size": 16})
    pparams = jax.tree.map(np.asarray, jax.jit(lambda r: init_pretrain_params(
        pcfg, r, max_hist_len=HIST, instr_len=TXT)[1])(jax.random.PRNGKey(7)))
    jpath = tmp_path / "jax.pkl"
    jpath.write_bytes(pickle.dumps({"step": 3, "params": pparams}))
    jagent.init_from_pretrain(str(jpath))
    path = str(tmp_path / "model_step_3.pt")
    torch.save({**{k: torch.from_numpy(v) for k, v in
                   pretrain_params_from_flax(pparams, agent.cfg.model).items()}, "step": 3}, path)
    skipped = agent.init_from_pretrain(path)
    assert skipped == []
    np.testing.assert_array_equal(agent.model.next_action.net[0].weight.detach().numpy(),
                                  pparams["next_action"]["dense1"]["kernel"].T)
    jep = jagent._ep_to_device(jagent.env.teacher_episode())
    ep = agent._ep_to_device(agent.env.teacher_episode())
    st = jagent.state
    want = jax.jit(lambda p, c, e, table: vars(jagent.episode_forward(
        p, c, e, jax.random.PRNGKey(0), deterministic=True, feat_table=table)))(
        st.params, st.cparams, jep, jagent._feat_table)
    with torch.no_grad():
        got = agent.episode_forward(ep, agent._feat_table)
    for name in ("logits", "values"):
        g, w = getattr(got, name).numpy(), np.asarray(want[name])
        fin = np.isfinite(w)
        np.testing.assert_array_equal(np.isfinite(g), fin, err_msg=name)
        np.testing.assert_allclose(g[fin], w[fin], rtol=0, atol=2e-4, err_msg=name)


def test_pretrain_cli_on_cpu_feeds_finetuning(tmp_path):
    """run.pretrain --synthetic --tiny --cpu: metrics.jsonl with ex/s at
    the log points and validation at the end, a checkpoint that
    load_reference_checkpoint reads (trunk and SAP head) and that
    fine-tuning takes through --init_pretrain with nothing skipped;
    --resume continues from its step. Every stack trains: the text
    stack's weights move."""
    out = tmp_path / "pt"
    args = ["--synthetic", "--tiny", "--cpu", "--batch_size", "4", "--warmup_steps", "1",
            "--valid_steps", "4", "--output_dir", str(out)]
    res = pretrain_cli.main(args + ["--num_steps", "4"])
    assert res["final_step"] == 4 and res["checkpoint"].endswith("model_step_4.pt")
    recs = [json.loads(x) for x in (out / "metrics.jsonl").read_text().splitlines()]
    assert any("ex_per_sec" in r for r in recs)
    assert any(k.startswith("val_unseen/") for k in recs[-1])
    sd, critic = load_reference_checkpoint(res["checkpoint"])
    assert critic is None and "next_action.net.4.weight" in sd
    assert not any(k.startswith(("mlm_head", "itm_head")) for k in sd)
    blob = torch.load(res["checkpoint"], weights_only=True)
    assert blob["step"] == 4
    fresh = init_pretrain(pretrain_cli.pretrain_model_config("r2r", True, 80), seed=0).state_dict()
    moved = [k for k in fresh if k.startswith("bert.encoder.layer.")
             and not torch.equal(fresh[k], blob[k])]
    assert moved, "the text stack did not train"
    res2 = pretrain_cli.main(args + ["--num_steps", "5", "--resume", res["checkpoint"]])
    assert res2["final_step"] == 5
    ft = finetune.main(["--task", "r2r", "--valid_only", "--synthetic", "--tiny", "--cpu",
                        "--init_pretrain", res["checkpoint"], "--output_dir", str(tmp_path / "ft")])
    assert 0.0 <= ft["val_unseen"]["sr"] <= 100.0
    assert "skipped" not in (tmp_path / "ft" / "valid.txt").read_text()

