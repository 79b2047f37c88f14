"""Tensor parallelism of the port against the JAX package's: the JAX
agent on ``make_mesh(num_data=1, num_model=2)`` and the port on two model
ranks (gloo), from the JAX agent's weights, tiny sizes, fp32, dropout
off: one IL update's loss and every model gradient (gathered from the
ranks), and its SGD step through a global-norm clip of 0.05 (so the step
clips) against the JAX optimizer's."""

import jax
import numpy as np
import optax

from test_torch_parallel import run_ranks
from test_torch_parallel_jax import PARITY, fast_jax_init, jax_agent, save_flax  # noqa: F401
from test_torch_train import named
from test_torch_train_grads import assert_grads_close
from torch_parallel_harness import NO_DROPOUT, TINY_MODEL
from vln_hamt_torch.configs import ModelConfig


def test_tensor_parallel_matches_jax_mesh(tmp_path):
    jagent, _ = jax_agent(1, 2, grad_clip=0.05)
    save_flax(jagent, tmp_path / "init.npz")
    st = jagent.state
    jep = jagent._ep_to_device(jagent.env.teacher_episode())
    weight = jagent.cfg.train.teacher_weight
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jagent._il_loss(p, st.cparams, jep, jax.random.PRNGKey(1), weight,
                                  jagent._feat_table), has_aux=True))(st.params)
    updates, _ = jagent.tx.update(jgrads, st.opt_state, st.params)
    jparams = optax.apply_updates(st.params, updates)
    norm = float(optax.global_norm(jgrads))
    assert norm > 0.05  # the step clips

    got = run_ranks(tmp_path, "tp", 2, "--model_shards", "2", "--steps", "il",
                    "--grad_clip", "0.05", "--flax_params", str(tmp_path / "init.npz"),
                    "--grads_out", str(tmp_path / "g.npz"), "--params_out", str(tmp_path / "p.npz"))
    np.testing.assert_allclose(got["losses"][0][1]["loss"], float(jloss), rtol=PARITY)
    cfg = ModelConfig(**TINY_MODEL, **NO_DROPOUT)
    grads = np.load(tmp_path / "g.npz")
    assert_grads_close({k[2:]: grads[k] for k in grads.files if k.startswith("0/")
                        and not k.startswith("0/critic.")}, named(jgrads, cfg))
    port = np.load(tmp_path / "p.npz")
    for k, v in named(jparams, cfg).items():
        np.testing.assert_allclose(port[k], v, atol=PARITY * 0.05, rtol=0, err_msg=k)
