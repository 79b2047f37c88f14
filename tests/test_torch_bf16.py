"""The port's bfloat16 compute against the JAX package's on the same
weights and inputs: the model's forward modes and the critic, a
teacher-forced episode, the IL loss and its gradients, and each
pretraining task's loss; and the dtype at every module boundary.

The yardstick of every comparison: the port's bf16 result lies within
``FACTOR`` times the JAX package's own bf16-to-fp32 difference on the
same inputs, plus ``ATOL`` scaled by the answer's largest entry below 1,
of the fp32 result (max-abs norms, per tensor): the port's bf16 is about
as accurate as the JAX package's. The
two bf16 computations round at different places (eager torch after each
op, XLA after each fusion), so their rounding errors are independent
draws of one size and their difference from each other is of the size
of either's own. A loss is one sum, whose difference is one draw that
may cancel to nearly nothing, so losses are compared as the vector of
the losses of ``N_LOSSES`` batches. The JAX side runs its Pallas
attention (interpret mode on the CPU), whose kernels widen bf16 q, k, v
to fp32 as the port's CUDA kernels and plain twins do. Tiny sizes,
dropout off, one thread."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_model import B, HIST, SIZES, _inputs, _port, flax_params  # noqa: F401
from test_torch_pretrain import BATCH, batcher, model_kwargs  # noqa: F401
from test_torch_pretrain import HIST as PT_HIST, TXT as PT_TXT, WORLD as PT_WORLD
from test_torch_train import (WORLD, make_env, named, tiny_cfg,
                              train_test_setup)  # noqa: F401 (autouse fixture)
from vln_hamt_tpu.agents.agent import HAMTAgent as JaxAgent
from vln_hamt_tpu.configs import HAMTConfig as JaxHAMTConfig
from vln_hamt_tpu.configs import ModelConfig as JaxModelConfig
from vln_hamt_tpu.env import ObsSpec as JaxObsSpec
from vln_hamt_tpu.env import R2RNavEnv as JaxEnv
from vln_hamt_tpu.models.hamt import HAMT as JaxHAMT
from vln_hamt_tpu.models.hamt import Critic as JaxCritic
from vln_hamt_tpu.pretrain.model import HAMTPretrain as JaxHAMTPretrain
from vln_hamt_tpu.pretrain.model import init_pretrain_params
from vln_hamt_torch.agents.agent import HAMTAgent
from vln_hamt_torch.configs import HAMTConfig, ModelConfig
from vln_hamt_torch.data.fixtures import make_synthetic_world
from vln_hamt_torch.env import ObsSpec, R2RNavEnv
from vln_hamt_torch.models.convert import pretrain_params_from_flax
from vln_hamt_torch.models.layers import extend_mask
from vln_hamt_torch.pretrain import (TASK_NAMES, PretrainBatcher, TrajectoryDataset,
                                     init_pretrain, make_synthetic_trajectories)
from vln_hamt_torch.pretrain.model import batch_to_device

# the yardstick: the worst ratio measured here is 2.2 (the text stack's
# query gradients with every stack trained); the port's distance from the
# JAX package's bf16 reaches 2.9 times the JAX package's own distance
# from fp32 (the summed IL losses)
FACTOR, ATOL = 3.0, 1e-3
# batches whose losses make one compared vector
N_LOSSES = 3
BF16 = {"dtype": "bfloat16"}


def assert_bf16_close(got, want_bf16, want_fp32, what=""):
    """|port bf16 - fp32| <= FACTOR |JAX bf16 - fp32| + ATOL min(1, |fp32|),
    max-abs over the finite entries (-inf at the same places on both
    sides), where fp32 is the JAX package's fp32 result: the absolute term
    scales with the answer's largest entry below 1, as chip_smoke.py's
    bf16_close, so it cannot swallow a tensor of small entries. Returns
    the port's and the JAX package's distance from it."""
    got, wb, wf = (np.asarray(x, np.float32) for x in (got, want_bf16, want_fp32))
    assert got.shape == wb.shape == wf.shape, what
    fin = np.isfinite(wf)
    np.testing.assert_array_equal(np.isfinite(got), fin, err_msg=what)
    np.testing.assert_array_equal(np.isfinite(wb), fin, err_msg=what)
    if not fin.any():
        return 0.0, 0.0
    ref = float(np.abs(wb[fin] - wf[fin]).max())
    err = float(np.abs(got[fin] - wf[fin]).max())
    scale = min(1.0, float(np.abs(wf[fin]).max()))
    assert err <= FACTOR * ref + ATOL * scale, (what, err, ref, scale)
    return err, ref


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


# ------------------------------------------------------- forward modes
@pytest.mark.parametrize("no_lang_ca", [False, True], ids=["ob_txt", "no_lang_ca"])
def test_forward_modes_match_jax_bf16(flax_params, no_lang_ca):  # noqa: F811
    """encode_text, init_history, encode_history, plan (logits and state)
    and the critic, each against the JAX package's bf16 run, with the
    dtype at every boundary: text and history bf16, logits, state and
    value fp32."""
    params, cparams = flax_params
    variant = dict(act_pred_token="ob_txt", no_lang_ca=no_lang_ca)
    jax_runs = {}
    for dtype in ("bfloat16", "float32"):
        jcfg = JaxModelConfig(**SIZES, **variant, dtype=dtype, use_pallas_attention=True)
        jm, jc = JaxHAMT(jcfg), JaxCritic(jcfg)
        x = {k: jnp.asarray(v) for k, v in _inputs().items()}
        hist = x["hist_tokens"].astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
        apply = lambda method, *a: jm.apply({"params": params}, *a, method=method)  # noqa: E731
        txt = apply(JaxHAMT.encode_text, x["txt_ids"], x["txt_mask"])
        logits, state = apply(JaxHAMT.plan, txt, x["txt_mask"], hist, x["hist_mask"],
                              x["ob_img"], x["ob_ang"], x["ob_nav"], x["ob_mask"])
        jax_runs[dtype] = {
            "text": txt, "hist0": apply(JaxHAMT.init_history, B),
            "hist_token": apply(JaxHAMT.encode_history, x["hist_img"], x["hist_ang"], 3,
                                x["pano_img"], x["pano_ang"]),
            "logits": logits, "state": state,
            "value": jc.apply({"params": cparams}, x["state"])}
    assert jax_runs["bfloat16"]["text"].dtype == jnp.bfloat16

    model, critic = _port(ModelConfig(**SIZES, **variant, **BF16), params, cparams)
    t = {k: torch.from_numpy(v) for k, v in _inputs().items()}
    with torch.no_grad():
        txt = model.encode_text(t["txt_ids"], t["txt_mask"])
        logits, state = model.plan(txt, t["txt_mask"], t["hist_tokens"].bfloat16(),
                                   t["hist_mask"], t["ob_img"], t["ob_ang"], t["ob_nav"],
                                   t["ob_mask"])
        got = {"text": txt, "hist0": model.init_history(B),
               "hist_token": model.encode_history(t["hist_img"], t["hist_ang"], 3,
                                                  t["pano_img"], t["pano_ang"]),
               "logits": logits, "state": state, "value": critic(t["state"])}
    for name in ("text", "hist0", "hist_token"):
        assert got[name].dtype == torch.bfloat16, name
    for name in ("logits", "state", "value"):
        assert got[name].dtype == torch.float32, name
    assert all(p.dtype == torch.float32 for p in model.parameters())
    for name, g in got.items():
        assert_bf16_close(_f32(g), _f32(jax_runs["bfloat16"][name]),
                          _f32(jax_runs["float32"][name]), name)


def test_masks_round_like_jax():
    """-10000 is -9984 in bf16, on both sides, before the kernel widens it."""
    mask = np.array([[True, False, True]])
    got = extend_mask(torch.from_numpy(mask), torch.bfloat16)
    from vln_hamt_tpu.models.layers import extend_mask as jax_extend_mask

    want = jax_extend_mask(jnp.asarray(mask), jnp.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    assert got.float()[0, 0, 0, 1].item() == -9984.0


# --------------------------------------------- episode, IL loss, grads
def make_bf16_pair(tiny_world, fix=True):
    """A JAX agent and a port agent (CPU) on the same weights and
    episodes in bf16, and a JAX agent in fp32 on the same weights."""
    world = make_synthetic_world(**WORLD)
    jcfg = tiny_cfg(JaxHAMTConfig, tiny_world, fix=fix).replace(
        model={"use_pallas_attention": True})
    cfg = tiny_cfg(HAMTConfig, world, fix=fix).replace(model=BF16)
    jagents = {}
    for dtype in ("bfloat16", "float32"):
        c = jcfg.replace(model={"dtype": dtype})
        jagents[dtype] = JaxAgent(c, make_env(JaxEnv, JaxObsSpec, tiny_world, c), seed=0)
        jagents[dtype].enable_feature_table()
    jagent = jagents["bfloat16"]
    agent = HAMTAgent(cfg, make_env(R2RNavEnv, ObsSpec, world, cfg), seed=0, device="cpu")
    agent.load_flax_params(jax.tree.map(np.asarray, jagent.state.params),
                           jax.tree.map(np.asarray, jagent.state.cparams))
    agent.enable_feature_table()
    return jagents, agent


def test_feature_table_and_episode_in_compute_dtype(tiny_world):
    _, agent = make_bf16_pair(tiny_world)
    assert agent._feat_table.dtype == torch.bfloat16
    ep = agent._ep_to_device(agent.env.teacher_episode())
    assert ep["cand_ang"].dtype == torch.float32  # cast inside expand_obs, as in JAX
    out = agent.episode_forward(ep, agent._feat_table)
    assert out.logits.dtype == out.values.dtype == torch.float32
    assert out.hist_cache.dtype == torch.bfloat16


def test_teacher_forced_episode_matches_jax_bf16(tiny_world):
    """Logits, values and the final history cache of one teacher-forced
    episode, deterministic."""
    jagents, agent = make_bf16_pair(tiny_world)
    ep = agent._ep_to_device(agent.env.teacher_episode())
    want = {}
    for dtype, jagent in jagents.items():
        jep = jagent._ep_to_device(jagent.env.teacher_episode())
        np.testing.assert_array_equal(ep["actions"].numpy(), np.asarray(jep["actions"]))
        st = jagent.state
        want[dtype] = jax.jit(lambda p, c, e, table, ja=jagent: vars(ja.episode_forward(
            p, c, e, jax.random.PRNGKey(0), deterministic=True, feat_table=table)))(
            st.params, st.cparams, jep, jagent._feat_table)
    with torch.no_grad():
        got = agent.episode_forward(ep, agent._feat_table)
    for name in ("logits", "values", "hist_cache"):
        assert_bf16_close(_f32(getattr(got, name)), _f32(want["bfloat16"][name]),
                          _f32(want["float32"][name]), name)


@pytest.mark.parametrize("fix", [True, False], ids=["fixed_embeddings", "all_trained"])
def test_il_loss_and_gradients_match_jax_bf16(tiny_world, fix):
    """Every parameter's gradient of the first batch's IL loss (fp32
    parameters, gradients through bf16 activations) against jax.grad of
    the JAX agent's bf16 _il_loss, and the IL losses of N_LOSSES batches."""
    jagents, agent = make_bf16_pair(tiny_world, fix=fix)
    eps = [agent._ep_to_device(agent.env.teacher_episode()) for _ in range(N_LOSSES)]
    losses, grads = {}, {}
    for dtype, jagent in jagents.items():
        grad_fn = jax.jit(jax.value_and_grad(
            lambda p, c, e, ja=jagent: ja._il_loss(p, c, e, jax.random.PRNGKey(1), 1.0,
                                                   ja._feat_table),
            argnums=(0, 1), has_aux=True))
        st, losses[dtype] = jagent.state, []
        for i in range(N_LOSSES):
            jep = jagent._ep_to_device(jagent.env.teacher_episode())
            np.testing.assert_array_equal(eps[i]["actions"].numpy(), np.asarray(jep["actions"]))
            (jloss, _), (jgp, _) = grad_fn(st.params, st.cparams, jep)
            losses[dtype].append(float(jloss))
            if i == 0:
                grads[dtype] = named(jgp, agent.cfg.model)
    agent.model.train()
    agent.critic.train()
    loss = agent._il_loss(eps[0], 1.0)
    loss.backward()
    assert loss.dtype == torch.float32
    got = {k: (p.grad.numpy() if p.grad is not None else np.zeros(p.shape, np.float32))
           for k, p in agent.model.named_parameters()}
    assert all(p.grad is None or p.grad.dtype == torch.float32
               for p in agent.model.parameters())
    assert got.keys() == grads["bfloat16"].keys()
    for k in got:
        assert_bf16_close(got[k], grads["bfloat16"][k], grads["float32"][k], k)
    with torch.no_grad():
        port_losses = [loss.item()] + [agent._il_loss(ep, 1.0).item() for ep in eps[1:]]
    assert_bf16_close(port_losses, losses["bfloat16"], losses["float32"], "IL losses")


# ------------------------------------------------------------ pretraining
@pytest.mark.parametrize("task", TASK_NAMES)
def test_pretrain_task_losses_match_jax_bf16(batcher, task):  # noqa: F811
    """Each proxy task's losses (fp32, from bf16 heads) on N_LOSSES
    batches against the JAX package's bf16 HAMTPretrain on the same
    weights and batches."""
    batches = [batcher.batch(task, BATCH) for _ in range(N_LOSSES)]
    params = jax_pretrain_params(0)
    want = {}
    for dtype in ("bfloat16", "float32"):
        jmodel = JaxHAMTPretrain(JaxModelConfig(**model_kwargs("r2r"), dtype=dtype,
                                                use_pallas_attention=True))
        loss_fn = jax.jit(lambda p, b, jm=jmodel: jm.apply({"params": p}, b, task,
                                                          deterministic=True)[0])
        want[dtype] = [float(loss_fn(params, {k: jnp.asarray(v) for k, v in b.items()}))
                       for b in batches]
    model = init_pretrain(ModelConfig(**model_kwargs("r2r"), **BF16), seed=0)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           pretrain_params_from_flax(params, model.config).items()}, strict=True)
    model.eval()
    got = []
    with torch.no_grad():
        for b in batches:
            loss, _ = model(batch_to_device(b, "cpu"), task)
            assert loss.dtype == torch.float32
            got.append(loss.item())
    assert_bf16_close(got, want["bfloat16"], want["float32"], task)


# the gradient whose card-against-CPU bf16 distance sat at 1.03 times its
# bound in a chip_smoke.py phase 12 run: the language self-attention
# output LayerNorm of the next-to-last cross-modal layer, whose language
# half still reaches MRC's loss (x_layers.2 of the r2r preset's 4)
MRC_TENSOR = "bert.encoder.x_layers.0.lang_self_att.output.LayerNorm.weight"


@functools.lru_cache(maxsize=None)
def jax_pretrain_init():
    """The JAX pretraining model's initializer, jitted once for the file."""
    jcfg = JaxModelConfig(**model_kwargs("r2r"))
    return jax.jit(lambda r: init_pretrain_params(jcfg, r, max_hist_len=PT_HIST,
                                                  instr_len=PT_TXT)[1])


@functools.lru_cache(maxsize=None)
def jax_pretrain_params(seed):
    """The JAX pretraining model's weights at ``seed`` as numpy (seed 0:
    ``test_torch_pretrain.jax_params``'s)."""
    return jax.tree.map(np.asarray, jax_pretrain_init()(jax.random.PRNGKey(seed)))


@functools.lru_cache(maxsize=None)
def jax_mrc_grad(dtype):
    """The JAX model's MRC gradient function in ``dtype``, jitted once: in
    bf16 through the Pallas kernels (interpret mode), as the yardstick's
    other bf16 sides; the fp32 reference through XLA's attention, the
    same math in fp32, which compiles in two thirds of the time."""
    jmodel = JaxHAMTPretrain(JaxModelConfig(**model_kwargs("r2r"), dtype=dtype,
                                            use_pallas_attention=dtype == "bfloat16"))
    return jax.jit(jax.grad(lambda p, b: jmodel.apply({"params": p}, b, "mrc",
                                                      deterministic=True)[0]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pretrain_mrc_gradients_match_jax_bf16(seed):
    """MRC's gradients in bf16 against the JAX package's bf16 gradients on
    the same weights and batch, for 3 seeds of the weights and the batch
    (the yardstick above). Prints the port's and the JAX package's
    distance from fp32 for MRC_TENSOR."""
    w = make_synthetic_world(**PT_WORLD)
    ds = TrajectoryDataset(make_synthetic_trajectories(w), w.graphs, w.feat_db,
                           image_feat_size=32, image_prob_size=16, max_txt_len=PT_TXT,
                           max_hist_len=PT_HIST)
    batch = PretrainBatcher(ds, seed=seed + 1, vocab_mask_range=(1000, 2000)).batch("mrc", BATCH)
    params = jax_pretrain_params(seed)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    cfg = ModelConfig(**model_kwargs("r2r"), **BF16)
    want = {dtype: pretrain_params_from_flax(jax.tree.map(
        lambda x: np.asarray(x, np.float32), jax_mrc_grad(dtype)(params, jb)), cfg)
        for dtype in ("bfloat16", "float32")}
    model = init_pretrain(cfg, seed=0)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           pretrain_params_from_flax(params, model.config).items()}, strict=True)
    model.eval()
    loss, _ = model(batch_to_device(batch, "cpu"), "mrc")
    loss.backward()
    for k, p in model.named_parameters():
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        dist = assert_bf16_close(_f32(got), want["bfloat16"][k], want["float32"][k], k)
        if k == MRC_TENSOR:
            print(f"seed {seed} {k}: port {dist[0]:.4g}, JAX {dist[1]:.4g}, "
                  f"ratio {dist[0] / dist[1]:.4g}")
