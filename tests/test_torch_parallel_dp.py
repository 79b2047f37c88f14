"""Data parallelism across two rank processes (gloo, CPU) against one
undistributed port process, tiny model, fp32, dropout off: every rank's
env replica builds the global batch of 4 and the rank trains on its 2
rows; the losses and their parts (global normalisers, the summed
gradients, the sampling noise drawn at the global batch) within rtol
2e-5 / atol 1e-6, the parameters after SGD within 1e-5 of each tensor's
largest entry, and the greedy trajectories (the val split sharded over
the ranks, gathered) identical."""

import pytest

from test_torch_parallel import assert_losses_close, assert_npz_close, run_ranks


@pytest.mark.parametrize("steps,evaluator", [
    ("il,il,fused,merged,replay", "device"),
    ("packed,packed", "packed"),
], ids=["il_fused_merged_replay", "packed_il"])
def test_two_rank_updates_match_one_rank(tmp_path, steps, evaluator):
    """IL, fused, merged and rollout-then-replay sample updates (or packed
    IL, each rank taking its slots of the global pack) and a greedy
    evaluation (device rollout, or the packed host loop) on two ranks
    against one."""
    argv = ("--steps", steps, "--eval", evaluator)
    want = run_ranks(tmp_path, "one", 0, *argv, "--params_out", str(tmp_path / "p1.npz"))
    got = run_ranks(tmp_path, "two", 2, *argv, "--params_out", str(tmp_path / "p2.npz"))
    assert got["world"] == 2 and want["world"] == 1
    assert_losses_close(got, want)
    assert_npz_close(tmp_path / "p2.npz", tmp_path / "p1.npz")
    assert got["traj"] == want["traj"] and len(want["traj"]) == 8
    assert got["eval_items"] == 4 and want["eval_items"] == 8  # the rank's shard
