"""Tensor-parallel pretraining (two model ranks) against the JAX
package's trainer on ``make_mesh(num_data=1, num_model=2)``, as
tests/test_torch_parallel_jax_pretrain.py holds data parallelism: each
task's loss, metrics and gathered gradients within the parity bar."""

from test_torch_parallel_jax_pretrain import check_pretraining_matches_jax


def test_tensor_parallel_pretraining_matches_jax_mesh(tmp_path):
    check_pretraining_matches_jax(tmp_path, 1, 2)
