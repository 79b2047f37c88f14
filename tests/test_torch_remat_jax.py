"""The port's updates under activation recomputation against the JAX
package's under the same policy (``remat_scan_body``'s
``jax.checkpoint``): dropout off, the same weights (carried over by
``models/convert.py``), one SGD update of IL and of the merged sample
update (its sampler replaced by the argmax on both sides, so that
nothing is drawn); the loss and every model and critic parameter after
the update within the tolerances of tests/test_torch_train_updates.py.
Tiny sizes, one thread."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import vln_hamt_torch.agents.rollout as rollout_module
from test_torch_train import (WORLD, make_env, named, tiny_cfg,
                              train_test_setup)  # noqa: F401 (autouse fixture)
from vln_hamt_tpu.agents.agent import HAMTAgent as JaxAgent
from vln_hamt_tpu.configs import HAMTConfig as JaxHAMTConfig
from vln_hamt_tpu.env import ObsSpec as JaxObsSpec
from vln_hamt_tpu.env import R2RNavEnv as JaxEnv
from vln_hamt_torch.agents.agent import HAMTAgent
from vln_hamt_torch.configs import HAMTConfig
from vln_hamt_torch.data.fixtures import make_synthetic_world
from vln_hamt_torch.env import ObsSpec, R2RNavEnv

# tests/test_torch_train_updates.py's: losses relative, parameters absolute
LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-5


def remat_pair(tiny_world, policy):
    """A JAX agent and a port agent (CPU) under ``policy``, the port with
    the JAX agent's weights, each over its own package's copy of the
    world, feature-table mode, SGD, every stack trained."""
    remat = {"num_x_layers": 1, "remat": True, "remat_policy": policy}
    world = make_synthetic_world(**WORLD)
    jcfg = tiny_cfg(JaxHAMTConfig, tiny_world, fix=False, optim="sgd", lr=0.05).replace(
        model=remat)
    cfg = tiny_cfg(HAMTConfig, world, fix=False, optim="sgd", lr=0.05).replace(model=remat)
    jagent = JaxAgent(jcfg, make_env(JaxEnv, JaxObsSpec, tiny_world, jcfg), seed=0)
    jagent.enable_feature_table()
    agent = HAMTAgent(cfg, make_env(R2RNavEnv, ObsSpec, world, cfg), seed=0, device="cpu")
    agent.load_flax_params(jax.tree.map(np.asarray, jagent.state.params),
                           jax.tree.map(np.asarray, jagent.state.cparams))
    agent.enable_feature_table()
    return jagent, agent


@pytest.mark.parametrize("update", ["il", "merged"])
@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_update_matches_jax(tiny_world, monkeypatch, policy, update):
    jagent, agent = remat_pair(tiny_world, policy)
    if update == "il":
        want = float(jagent.train_iteration("teacher")["loss"])
        got = agent.train_iteration("teacher")["loss"]
    else:
        jagent.merged_sample_update = agent.merged_sample_update = True
        monkeypatch.setattr(jax.random, "categorical",
                            lambda key, logits, axis=-1: jnp.argmax(logits, axis=axis))
        monkeypatch.setattr(rollout_module, "gumbel_max",
                            lambda logits, generator, rows=None: logits.argmax(-1))
        want = float(jagent.train_iteration("sample")["loss"])
        got = agent.train_iteration("sample")["loss"]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    for module, params in ((agent.model, named(jagent.state.params, agent.cfg.model)),
                           (agent.critic, named(jagent.state.cparams))):
        for k, v in module.state_dict().items():
            np.testing.assert_allclose(v.numpy(), params[k], atol=PARAM_ATOL, rtol=0,
                                       err_msg=k)
