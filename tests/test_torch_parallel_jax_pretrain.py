"""Pretraining across two rank processes of the port against the JAX
package's trainer on the matching mesh of the conftest's CPU devices
(here data parallel (2, 1); tensor parallel (1, 2) in
tests/test_torch_parallel_jax_pretrain_tp.py), both built as the CLIs
build ``--synthetic --tiny`` at batch 4 and from the JAX trainer's
initial weights: one update of each of the six tasks, ITM's in-batch
negatives over the global batch included; each task's loss and metrics
within 2e-4 (the port's parity bar) and its gradients, summed over the
data ranks and gathered over the model ranks, against ``jax.grad`` of
the JAX loss on the mesh-sharded batch. Dropout off on both sides."""

import dataclasses

import jax
import numpy as np

from test_torch_parallel import run_ranks
from test_torch_parallel_jax import PARITY
from test_torch_train_grads import assert_grads_close
from vln_hamt_tpu.configs import ModelConfig as JaxModelConfig
from vln_hamt_tpu.data.feature_db import build_feature_table as jax_build_feature_table
from vln_hamt_tpu.parallel import mesh as jax_mesh
from vln_hamt_tpu.pretrain import PretrainBatcher as JaxPretrainBatcher
from vln_hamt_tpu.pretrain import PretrainTrainer as JaxPretrainTrainer
from vln_hamt_tpu.run import pretrain as jax_pretrain_cli
from vln_hamt_torch.models.convert import pretrain_params_from_flax
from vln_hamt_torch.run import pretrain as pretrain_cli

BATCH = 4


def jax_trainer(num_data: int, num_model: int):
    """The JAX trainer of the port CLI's ``--synthetic --tiny`` build on a
    (num_data, num_model) mesh, and the port's parsed arguments."""
    args = pretrain_cli.parse_args(["--synthetic", "--tiny", "--batch_size", str(BATCH)])
    mcfg = pretrain_cli.resolve(args)
    jcfg = JaxModelConfig(**{f.name: getattr(mcfg, f.name)
                             for f in dataclasses.fields(JaxModelConfig)})
    train_ds, _ = jax_pretrain_cli.build_synthetic(args, jcfg)
    table, offsets = jax_build_feature_table(train_ds.graphs, train_ds.feat_db)
    train_ds.set_feat_offsets(offsets)
    mesh = jax_mesh.make_mesh(num_data, num_model, devices=jax.devices()[:num_data * num_model])
    trainer = JaxPretrainTrainer(jcfg, JaxPretrainBatcher(train_ds, seed=args.seed),
                                 tasks=args.tasks, mix_ratio=args.mix_ratio, batch_size=BATCH,
                                 seed=args.seed, mesh=mesh, feat_table=table)
    return trainer, args, mcfg


def check_pretraining_matches_jax(tmp_path, num_data: int, num_model: int) -> None:
    jt, args, mcfg = jax_trainer(num_data, num_model)
    flat = {f"params/{jax_mesh._flatten_path(p)}": np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(jt.params)[0]}
    np.savez(tmp_path / "init.npz", **flat)
    want, want_grads = [], {}
    for task in args.tasks:
        batch = jax_mesh.shard_batch(jt.batcher.batch(task, BATCH), jt.mesh, batch_size=BATCH)
        (loss, aux), grads = jax.jit(jax.value_and_grad(
            lambda p, b: jt.model.apply({"params": p}, b, task, deterministic=True,
                                        feat_table=jt._feat_table), has_aux=True))(
            jt.params, batch)
        want.append((task, float(loss), {k: float(v) for k, v in aux.items()}))
        want_grads.update({f"{task}/{k}": v for k, v in pretrain_params_from_flax(
            jax.tree.map(np.asarray, grads), mcfg).items()})

    got = run_ranks(tmp_path, "two", 2, "--pretrain", "--batch", str(BATCH), "--lr", "0",
                    "--model_shards", str(num_model), "--flax_params",
                    str(tmp_path / "init.npz"), "--grads_out", str(tmp_path / "g.npz"))
    assert [t for t, _ in got["losses"]] == [t for t, _, _ in want]
    for (task, g), (_, loss, aux) in zip(got["losses"], want):
        np.testing.assert_allclose(g["loss"], loss, rtol=0, atol=PARITY, err_msg=task)
        for k, v in aux.items():
            np.testing.assert_allclose(g[k], v, rtol=0, atol=PARITY, err_msg=f"{task} {k}")
    grads = np.load(tmp_path / "g.npz")
    # a parameter no task reaches has no gradient on the port's side
    assert_grads_close({k: grads[k] for k in grads.files},
                       {k: v for k, v in want_grads.items() if k in grads.files})
    assert {k for k, v in want_grads.items() if np.abs(v).max() > 0} <= set(grads.files)


def test_data_parallel_pretraining_matches_jax_mesh(tmp_path):
    check_pretraining_matches_jax(tmp_path, 2, 1)
