"""Pretraining across two rank processes (gloo, CPU) against one
undistributed port process, tiny sizes, fp32, dropout off, one update per
task at batch 4 with learning rate 0 (each task's update from the same
weights): the losses and metrics (global counts) within rtol 2e-5, each
task's gradients summed over the ranks within 1e-5 of the one rank's
(ITM's in-batch negatives over the whole batch included), validation
split over the data ranks; data and tensor parallel. The sharded feed
draws other batches on each rank (batchers seeded seed + 1000 x rank)."""

import numpy as np
import pytest

from test_torch_parallel import assert_losses_close, assert_npz_close, run_ranks


@pytest.mark.parametrize("model_shards", [1, 2], ids=["data", "model"])
def test_pretraining_matches_one_rank(tmp_path, model_shards):
    argv = ("--pretrain", "--batch", "4", "--lr", "0", "--validate")
    want = run_ranks(tmp_path, "one", 0, *argv, "--grads_out", str(tmp_path / "g1.npz"))
    got = run_ranks(tmp_path, "two", 2, *argv, "--model_shards", str(model_shards),
                    "--grads_out", str(tmp_path / "g2.npz"))
    assert [t for t, _ in want["losses"]] == ["mlm", "mrc", "itm", "sap", "sar", "sprel"]
    assert_losses_close(got, want)
    assert_npz_close(tmp_path / "g2.npz", tmp_path / "g1.npz")
    for task, stats in want["val"].items():
        for k, v in stats.items():
            np.testing.assert_allclose(got["val"][task][k], v, rtol=2e-5, atol=1e-6,
                                       err_msg=(task, k))


def test_sharded_feed_draws_per_rank(tmp_path):
    got = run_ranks(tmp_path, "sharded", 2, "--pretrain", "--batch", "4", "--sharded_feed", "2")
    rank0, rank1 = got["batches"]
    assert len(rank0) == 6 and all(a != b for a, b in zip(rank0, rank1))
    assert all(np.isfinite(r["loss"]) for _, r in got["losses"])
