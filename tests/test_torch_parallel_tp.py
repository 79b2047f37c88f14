"""Tensor parallelism (``model_shards`` 2) across two rank processes
(gloo, CPU) against one undistributed port process: the tiny model's 4
heads split 2 per rank; the IL and merged updates' losses, the gathered
gradients of the first update and the parameters after SGD with a
clipping global norm (0.05, so every step clips), the greedy
trajectories; a 2 x 2 mesh too. Dropout on: the data ranks draw other
masks and attention seeds, the model ranks the same masks and their own
seeds, and their replicated weights and activations stay equal.
Checkpoints: a tensor-parallel save is the one-rank save and loads in one
process; the directory checkpoint too."""

import numpy as np
import pytest
import torch

from test_torch_parallel import assert_losses_close, assert_npz_close, run_ranks
from torch_parallel_harness import finetune_config, make_env, parse_args
from vln_hamt_torch.agents.agent import HAMTAgent


@pytest.mark.parametrize("ranks", [2, 4], ids=["1x2", "2x2"])
def test_tensor_parallel_matches_one_rank(tmp_path, ranks):
    argv = ("--steps", "il,merged", "--grad_clip", "0.05", "--eval", "device")
    want = run_ranks(tmp_path, "one", 0, *argv, "--grads_out", str(tmp_path / "g1.npz"),
                     "--params_out", str(tmp_path / "p1.npz"))
    got = run_ranks(tmp_path, "tp", ranks, *argv, "--model_shards", "2",
                    "--grads_out", str(tmp_path / "g2.npz"),
                    "--params_out", str(tmp_path / "p2.npz"))
    assert_losses_close(got, want)
    assert_npz_close(tmp_path / "g2.npz", tmp_path / "g1.npz")
    assert_npz_close(tmp_path / "p2.npz", tmp_path / "p1.npz")
    assert got["traj"] == want["traj"]


@pytest.mark.parametrize("model_shards", [1, 2], ids=["data", "model"])
def test_dropout_streams_per_rank(tmp_path, model_shards):
    """With dropout on, one IL update on two ranks: data ranks draw other
    hidden-dropout masks and attention seeds; model ranks the same masks,
    their own attention seeds (their own heads), and keep equal
    replicated weights and equal train-mode logits. The losses are
    finite."""
    res = run_ranks(tmp_path, "drop", 2, "--steps", "il", "--dropout", "--optim", "adamw",
                    "--lr", "1e-3", "--model_shards", str(model_shards))
    a, b = res["dropout"]
    assert np.isfinite(res["losses"][0][1]["loss"]) and np.isfinite([a["logits"], b["logits"]]).all()
    assert a["seed"] != b["seed"]
    if model_shards == 1:
        assert (a["data_index"], b["data_index"]) == (0, 1)
        assert a["mask"] != b["mask"]
    else:
        assert (a["model_index"], b["model_index"]) == (0, 1)
        assert a["mask"] == b["mask"]
        assert a["logits"] == b["logits"] and a["replicated"] == b["replicated"]


def test_tensor_parallel_checkpoints(tmp_path):
    """Two adamw updates at learning rate 0 (so the moments hold the
    gradients) on one rank and on two model ranks, each saved as a .pt
    file and a directory (asynchronous) and loaded back with the
    optimizer; the two-rank files hold the one-rank layout: the .pt
    equals the one-rank save, weights and moments, and both load into a
    one-rank agent with its optimizer."""
    argv = ("--steps", "il,merged", "--optim", "adamw", "--lr", "0")
    for tag, ranks, extra in (("one", 0, ()), ("tp", 2, ("--model_shards", "2"))):
        (tmp_path / tag).mkdir()
        res = run_ranks(tmp_path, tag, ranks, *argv, *extra, "--ckpt_dir", str(tmp_path / tag))
        assert res["ckpt"] == {"agent.pt": True, "agent": True}
    one = torch.load(tmp_path / "one" / "agent.pt", weights_only=True)
    tp = torch.load(tmp_path / "tp" / "agent.pt", weights_only=True)
    assert tp["step"] == one["step"] == 2

    def close(a, b, what):
        assert a.shape == b.shape, what
        assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item() + 1e-12, what

    for part in ("model", "critic"):
        assert tp[part].keys() == one[part].keys()
        for k, v in one[part].items():
            close(tp[part][k], v, k)
    for part in ("optimizer", "critic_optimizer"):
        assert tp[part]["state"].keys() == one[part]["state"].keys()
        for i, st in one[part]["state"].items():
            for key in ("mu", "nu"):
                close(tp[part]["state"][i][key], st[key], (part, i, key))
    args = parse_args(["--cpu", "--tiny"])
    cfg, world = finetune_config(args)
    for name in ("agent.pt", "agent"):
        agent = HAMTAgent(cfg, make_env(cfg, world, world.instr_data, 4), device="cpu")
        assert agent.load(str(tmp_path / "tp" / name), resume_optimizer=True) == 2
        for k, v in agent.model.state_dict().items():
            torch.testing.assert_close(v, tp["model"][k], rtol=0, atol=0)
        assert agent.optimizer.param_groups[0]["count"] == 2
