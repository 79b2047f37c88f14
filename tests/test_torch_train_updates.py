"""The port's IL updates against the JAX agent's: three SGD updates
through ``train_iteration``, and optax's Adam state carried across
before one more update on both sides. Tiny sizes, one thread."""

import jax
import numpy as np
import optax

from test_torch_train import (GRAD_ATOL, GRAD_REL, SHIFT_ONLY, assert_params_close,
                                 make_pair, named, train_test_setup)  # noqa: F401 (autouse fixture)
from vln_hamt_torch.models.convert import (adam_state_from_flax, critic_params_from_flax,
                                           params_from_flax)


def test_three_sgd_il_updates_match_jax(tiny_world):
    """train_iteration('teacher') three times on both sides, SGD (whose
    step is linear in the gradient, so the parameters compare
    meaningfully), dropout off."""
    jagent, agent = make_pair(tiny_world, fix=False, optim="sgd", lr=0.05)
    losses = [(float(jagent.train_iteration("teacher")["loss"]),
               agent.train_iteration("teacher")["loss"]) for _ in range(3)]
    for want, got in losses:
        np.testing.assert_allclose(got, want, rtol=1e-5)
    assert losses[0][1] != losses[1][1]  # the parameters moved
    assert_params_close(agent, jagent, atol=1e-5)


def test_optax_state_carried_across(tiny_world):
    """Two adamw IL updates in JAX; params and optax state carried into
    the port; one more update on both sides gives the same moments and
    parameters."""
    jagent, agent = make_pair(tiny_world, fix=False, optim="adamw", lr=1e-3)
    for _ in range(2):
        jagent.train_iteration("teacher")
        agent.env.reset()  # the port's env skips the same two batches
    st = jagent.state
    agent.load_flax_params(jax.tree.map(np.asarray, st.params),
                           jax.tree.map(np.asarray, st.cparams))
    adam = lambda s: next(x for x in jax.tree.leaves(
        s, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(x, optax.ScaleByAdamState))
    mcfg = agent.cfg.model
    for opt, module, opt_state, convert in (
            (agent.optimizer, agent.model, st.opt_state, lambda t: params_from_flax(t, mcfg)),
            (agent.critic_optimizer, agent.critic, st.copt_state, critic_params_from_flax)):
        a = adam(opt_state)
        opt.load_adam_state(dict(module.named_parameters()), adam_state_from_flax(
            a.count, jax.tree.map(np.asarray, a.mu), jax.tree.map(np.asarray, a.nu), convert))
    assert agent.optimizer.param_groups[0]["count"] == 2
    want = float(jagent.train_iteration("teacher")["loss"])
    got = agent.train_iteration("teacher")["loss"]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert agent.optimizer.param_groups[0]["count"] == 3
    jadam = adam(jagent.state.opt_state)
    for key in ("mu", "nu"):
        want_m = named(getattr(jadam, key), mcfg)
        for name, p in agent.model.named_parameters():
            got_m = agent.optimizer.state[p][key].numpy()
            scale = max(np.abs(want_m[name]).max(), 1e-12)
            atol = GRAD_ATOL if key == "mu" else GRAD_ATOL ** 2  # nu is quadratic
            assert np.abs(got_m - want_m[name]).max() <= GRAD_REL * scale + atol, (key, name)
    # an adam step moves each parameter by about lr in the direction of
    # mu / sqrt(nu): the parameters agree closely, except where the
    # gradient is rounding noise on both sides (SHIFT_ONLY: moments 1e-5
    # of the largest and below), whose step may take either sign
    want_mu = named(jadam.mu, mcfg)
    top = max(np.abs(m).max() for m in want_mu.values())
    noise = {k for k, m in want_mu.items() if np.abs(m).max() <= 1e-5 * top}
    assert noise and all(k.endswith(SHIFT_ONLY) for k in noise), sorted(noise)
    assert_params_close(agent, jagent, atol=1e-5, noise=noise,
                         noise_atol=2 * agent.cfg.train.lr)
