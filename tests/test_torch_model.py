"""The port's HAMT and Critic against the JAX package's on the same
weights: flax params from ``init_hamt_params`` are carried across with
``params_from_flax`` and every forward mode is compared at a tiny
config (the sizes of tests/test_parity.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vln_hamt_tpu.configs import ModelConfig as JaxModelConfig
from vln_hamt_tpu.models.convert import convert_critic_state_dict, convert_navcmt_state_dict
from vln_hamt_tpu.models.hamt import HAMT as JaxHAMT
from vln_hamt_tpu.models.hamt import Critic as JaxCritic
from vln_hamt_tpu.models.hamt import init_hamt_params
from vln_hamt_torch.configs import ModelConfig
from vln_hamt_torch.models.convert import critic_params_from_flax, params_from_flax
from vln_hamt_torch.models.hamt import Critic, HAMT, init_hamt
from vln_hamt_torch.ops import attention as tops

H, HEADS, INTER, IMG, VOCAB = 48, 4, 96, 16, 60
L_LAYERS, X_LAYERS, PANO_LAYERS = 2, 2, 1
B, L, HIST, NOB, V = 2, 7, 3, 12, 36
# fp32 on both sides through ~7 layers; different summation orders and
# LayerNorm variance formulas (flax E[x^2]-E[x]^2, torch two-pass)
ATOL = 2e-4

SIZES = dict(vocab_size=VOCAB, hidden_size=H, num_attention_heads=HEADS,
             intermediate_size=INTER, max_position_embeddings=32,
             num_l_layers=L_LAYERS, num_x_layers=X_LAYERS,
             num_h_pano_layers=PANO_LAYERS, image_feat_size=IMG,
             max_action_steps=8)
VARIANTS = [
    dict(act_pred_token=t, no_lang_ca=False)
    for t in ("ob_txt", "ob", "ob_hist", "ob_txt_hist")
] + [dict(act_pred_token="ob_txt", no_lang_ca=True)]


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def flax_params():
    """One parameter tree serves every variant: act_pred_token and
    no_lang_ca change the forward, not the parameters."""
    _, _, params, cparams = init_hamt_params(
        JaxModelConfig(**SIZES), jax.random.PRNGKey(0), views=V,
        num_ob_tokens=NOB, instr_len=L, hist_len=HIST)
    params = jax.tree.map(np.asarray, params)
    cparams = jax.tree.map(np.asarray, cparams)
    # non-trivial [CLS] and LayerNorm affine terms so the mapping of
    # every leaf is exercised (flax initializes them to 0 / 1)
    rng = np.random.default_rng(5)
    params = jax.tree.map(lambda x: x + 0.05 * rng.standard_normal(x.shape).astype(np.float32),
                          params)
    return params, cparams


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    txt_mask = np.ones((B, L), bool)
    txt_mask[1, 5:] = False
    hist_mask = np.ones((B, HIST), bool)
    hist_mask[0, 2:] = False
    nav = np.zeros((B, NOB), np.int32)
    nav[:, :4] = 1
    nav[:, 4] = 2
    ob_mask = nav > 0
    ob_mask[:, 8:] = True
    return {
        "txt_ids": rng.integers(1, VOCAB, (B, L)).astype(np.int32),
        "txt_mask": txt_mask,
        "hist_tokens": rng.standard_normal((B, HIST, H)).astype(np.float32),
        "hist_mask": hist_mask,
        "ob_img": rng.standard_normal((B, NOB, IMG)).astype(np.float32),
        "ob_ang": rng.standard_normal((B, NOB, 4)).astype(np.float32) * 0.3,
        "ob_nav": nav,
        "ob_mask": ob_mask,
        "hist_img": rng.standard_normal((B, IMG)).astype(np.float32),
        "hist_ang": rng.standard_normal((B, 4)).astype(np.float32) * 0.3,
        "pano_img": rng.standard_normal((B, V, IMG)).astype(np.float32),
        "pano_ang": rng.standard_normal((B, V, 4)).astype(np.float32) * 0.3,
        "state": rng.standard_normal((B, H)).astype(np.float32),
    }


def _port(cfg, params, cparams):
    model, critic = HAMT(cfg), Critic(cfg)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in params_from_flax(params, cfg).items()}, strict=True)
    critic.load_state_dict({k: torch.from_numpy(v)
                            for k, v in critic_params_from_flax(cparams).items()}, strict=True)
    return model.eval(), critic.eval()


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)  # -inf at the same places
    np.testing.assert_allclose(got[fin], want[fin], atol=ATOL, rtol=0)


@pytest.mark.parametrize("pallas", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("variant", VARIANTS,
                         ids=lambda v: v["act_pred_token"] + ("_nolangca" * v["no_lang_ca"]))
def test_forward_modes_match_jax(flax_params, variant, pallas):
    params, cparams = flax_params
    jcfg = JaxModelConfig(**SIZES, **variant, use_pallas_attention=pallas)
    jm, jc = JaxHAMT(jcfg), JaxCritic(jcfg)
    model, critic = _port(ModelConfig(**SIZES, **variant), params, cparams)
    x = _inputs()
    j = {k: jnp.asarray(v) for k, v in x.items()}
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    apply = lambda method, *a: jm.apply({"params": params}, *a, method=method)
    before = dict(tops.launch_counts)
    with torch.no_grad():
        txt_j = apply(JaxHAMT.encode_text, j["txt_ids"], j["txt_mask"])
        txt_t = model.encode_text(t["txt_ids"], t["txt_mask"])
        _close(txt_t, txt_j)

        _close(model.init_history(B), apply(JaxHAMT.init_history, B))
        _close(model.encode_history(t["hist_img"], t["hist_ang"], 3,
                                    t["pano_img"], t["pano_ang"]),
               apply(JaxHAMT.encode_history, j["hist_img"], j["hist_ang"], 3,
                     j["pano_img"], j["pano_ang"]))

        names = ("hist_tokens", "hist_mask", "ob_img", "ob_ang", "ob_nav", "ob_mask")
        logits_j, state_j = apply(JaxHAMT.plan, txt_j, j["txt_mask"], *(j[n] for n in names))
        logits_t, state_t = model.plan(txt_t, t["txt_mask"], *(t[n] for n in names))
        _close(logits_t, logits_j)
        _close(state_t, state_j)

        _close(critic(t["state"]), jc.apply({"params": cparams}, j["state"]))
    assert tops.launch_counts == before


def test_state_dict_round_trips_through_reference_converter():
    """The port's state dict IS a NavCMT state dict: the JAX package's
    converter maps it to flax params, and params_from_flax maps those
    back to the same tensors."""
    cfg = ModelConfig(**SIZES)
    model, critic = init_hamt(cfg, seed=3)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    flax = convert_navcmt_state_dict(sd, num_l_layers=L_LAYERS, num_x_layers=X_LAYERS,
                                     num_h_pano_layers=PANO_LAYERS)
    back = params_from_flax(flax, cfg)
    assert back.keys() == sd.keys()
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k], err_msg=k)
    csd = {k: v.numpy() for k, v in critic.state_dict().items()}
    cback = critic_params_from_flax(convert_critic_state_dict(csd))
    assert cback.keys() == csd.keys()
    for k in csd:
        np.testing.assert_array_equal(cback[k], csd[k], err_msg=k)
    # the flax tree has exactly the JAX model's structure and shapes
    _, _, ref_params, _ = init_hamt_params(JaxModelConfig(**SIZES), jax.random.PRNGKey(0),
                                           views=V, num_ob_tokens=NOB, instr_len=L,
                                           hist_len=HIST)
    assert (jax.tree.map(np.shape, flax)
            == jax.tree.map(np.shape, jax.tree.map(np.asarray, ref_params)))


def test_init_follows_flax_defaults():
    """Seeded init: reproducible, [CLS] zero, LayerNorms one/zero, and
    kernels with flax's lecun-normal spread."""
    cfg = dataclasses.replace(ModelConfig(**SIZES), intermediate_size=512)
    a, _ = init_hamt(cfg, seed=7)
    b, _ = init_hamt(cfg, seed=7)
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), k
    assert not a.hist_embeddings.cls_token.any()
    ln = a.embeddings.LayerNorm
    assert torch.equal(ln.weight, torch.ones_like(ln.weight)) and not ln.bias.any()
    w = a.encoder.layer[0].output.dense.weight  # (48, 512): fan_in 512
    assert abs(w.std().item() * 512 ** 0.5 - 1.0) < 0.05
    assert w.abs().max().item() <= 2.0 / 0.87962566103423978 / 512 ** 0.5 + 1e-6
