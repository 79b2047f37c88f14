"""The port's teacher-forced episode forward and IL gradients against the
JAX package on the same weights and episodes (set-up shared with
tests/test_torch_train.py). Tiny sizes, one thread."""

import jax
import numpy as np
import pytest
import torch

from test_torch_train import (GRAD_ATOL, GRAD_REL, make_pair, named,
                              train_test_setup)  # noqa: F401 (autouse fixture)
from vln_hamt_torch.ops import attention as tops

# fp32 through the tiny model's 2 text + 2 cross-modal layers (as
# tests/test_torch_eval.py)
ATOL = 2e-4


def assert_grads_close(got, want):
    assert got.keys() == want.keys()
    for k in want:
        scale = max(np.abs(want[k]).max(), 1e-8)
        err = np.abs(got[k] - want[k]).max()
        assert err <= GRAD_REL * scale + GRAD_ATOL, (k, err, scale)


# ------------------------------------------------------ episode forward
def test_episode_forward_matches_jax(tiny_world):
    """Logits, states, values, the final cache and the bootstrap value of
    the teacher-forced episode, deterministic, on the same episode."""
    jagent, agent = make_pair(tiny_world)
    jep = jagent._ep_to_device(jagent.env.teacher_episode())
    ep = agent._ep_to_device(agent.env.teacher_episode())
    np.testing.assert_array_equal(ep["node_idx"].numpy(), np.asarray(jep["node_idx"]))
    np.testing.assert_array_equal(ep["actions"].numpy(), np.asarray(jep["actions"]))
    # a final observation for the bootstrap branch: the last step's
    for key in ("node_idx", "view_index", "cand_point", "cand_ang"):
        jep["final_" + key] = jep[key][:, -1]
        ep["final_" + key] = ep[key][:, -1]
    st = jagent.state
    fwd = jax.jit(lambda p, c, e, table: vars(jagent.episode_forward(
        p, c, e, jax.random.PRNGKey(0), deterministic=True, feat_table=table)))
    want = fwd(st.params, st.cparams, jep, jagent._feat_table)
    before = dict(tops.launch_counts)
    with torch.no_grad():
        got = agent.episode_forward(ep, agent._feat_table)
    assert tops.launch_counts == before
    for name in ("logits", "states", "values", "last_value", "hist_cache"):
        g, w = getattr(got, name).numpy(), np.asarray(want[name])
        assert g.shape == w.shape, name
        fin = np.isfinite(w)
        np.testing.assert_array_equal(np.isfinite(g), fin, err_msg=name)
        np.testing.assert_allclose(g[fin], w[fin], atol=ATOL, rtol=0, err_msg=name)


# -------------------------------------------------------- IL gradients
@pytest.mark.parametrize("fix,no_lang_ca", [(True, False), (False, False), (False, True)],
                         ids=["fixed_embeddings", "all_trained", "no_lang_ca"])
def test_il_gradients_match_jax(tiny_world, fix, no_lang_ca):
    """The IL loss and every parameter's gradient against jax.grad of the
    JAX agent's _il_loss, all dropout rates 0; with fix_lang_embedding /
    fix_hist_embedding on, the frozen parts get no gradient on either
    side; under no_lang_ca (the rxr / r4r presets) the precomputed
    language stream of the cross-modal layers takes its gradient once
    per episode."""
    jagent, agent = make_pair(tiny_world, fix=fix, no_lang_ca=no_lang_ca)
    jep = jagent._ep_to_device(jagent.env.teacher_episode())
    ep = agent._ep_to_device(agent.env.teacher_episode())
    st = jagent.state
    (jloss, _), (jgp, jgc) = jax.jit(jax.value_and_grad(
        lambda p, c: jagent._il_loss(p, c, jep, jax.random.PRNGKey(1), 1.0,
                                     jagent._feat_table),
        argnums=(0, 1), has_aux=True))(st.params, st.cparams)

    agent.model.train()
    agent.critic.train()
    loss = agent._il_loss(ep, 1.0)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    grads = {k: (p.grad.numpy() if p.grad is not None else np.zeros(p.shape, np.float32))
             for k, p in agent.model.named_parameters()}
    want = named(jgp, agent.cfg.model)
    assert_grads_close(grads, want)
    frozen = [k for k, p in agent.model.named_parameters() if p.grad is None]
    if fix:
        assert "embeddings.word_embeddings.weight" in frozen
        assert "hist_embeddings.pano_encoder.layer.0.attention.self.query.weight" in frozen
        assert all(not np.abs(want[k]).any() for k in frozen)
    else:
        assert frozen == ["img_embeddings.nav_type_embedding.weight"] or not frozen
    # the IL loss does not reach the critic, on either side
    assert all(p.grad is None for p in agent.critic.parameters())
    assert all(not np.abs(x).any() for x in jax.tree.leaves(jax.tree.map(np.asarray, jgc)))
