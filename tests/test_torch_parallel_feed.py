"""The host-sharded feed across two rank processes (gloo, CPU) against one
undistributed port process: each rank's env holds only its rows of the
one-rank env's minibatch stream at batch 2 (``enable_host_sharded_feed``);
teacher and merged sample updates within rtol 2e-5 / atol 1e-6, for R2R
and for REVERIE's object grounding (dual CE, object tables), and the
greedy trajectories and grounded objects of a sharded val split
identical, also when the shards are uneven."""

import pytest

from test_torch_parallel import assert_losses_close, run_ranks


@pytest.mark.parametrize("task", ["r2r", "reverie"])
def test_sharded_feed_matches_one_rank(tmp_path, task):
    argv = ("--task", task, "--sharded_feed", "2", "--steps", "il,merged", "--eval", "device")
    want = run_ranks(tmp_path, "one", 0, *argv)
    got = run_ranks(tmp_path, "two", 2, *argv)
    assert_losses_close(got, want)
    assert got["traj"] == want["traj"] and got["obj_preds"] == want["obj_preds"]
    if task == "reverie":
        assert all(v is not None for v in want["obj_preds"].values())


@pytest.mark.parametrize("evaluator", ["device", "packed"])
def test_uneven_eval_shards(tmp_path, evaluator):
    """Seven val items on two ranks (3 and 4): each rank evaluates its own
    shard without collectives and the gathered trajectories are the one
    rank's, on the device rollout and on the packed host loop."""
    argv = ("--steps", "il", "--eval", evaluator, "--val_items", "7")
    want = run_ranks(tmp_path, "one", 0, *argv)
    got = run_ranks(tmp_path, "two", 2, *argv)
    assert len(want["traj"]) == 7 and got["traj"] == want["traj"]
    assert got["eval_items"] == 3  # rank 0's shard
