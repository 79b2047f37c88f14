"""The fine-tuning CLI's own multi-rank wiring, trained: two rank
processes of ``run/finetune.py --synthetic --tiny`` (gloo on the CPU,
under a timeout), two IL + merged sample updates by SGD at rate 0.05
with dropout off, against one process: with ``--model_shards
2`` the same train split, with ``--data_shards 2 --sharded_feed`` each
rank's train env on its shard of the split (``sel_data_idxs``) and the
one process fed those shards' minibatches joined. The selection
metrics agree and the ``latest.pt`` weights (rank 0's, in the one-rank
layout) are the one process's within 1e-5 of each tensor's largest
entry."""

import json

import pytest
import torch

import torch_parallel_harness as harness
from test_torch_parallel import RANK_TIMEOUT
from vln_hamt_torch.parallel.mesh import Mesh
from vln_hamt_torch.run import finetune

TINY = ["--synthetic", "--tiny", "--cpu", "--iters", "2", "--log_every", "2", "--lr", "0.05"]


def joined_shards(monkeypatch, n: int, minibatches: int = 8) -> None:
    """The one process's train env fed, minibatch by minibatch, the rows
    of the ``n`` data ranks' sharded train envs, in rank order."""
    build = finetune.build_synthetic_dataset

    def joined(cfg, seed=0, **kw):
        cfg, train_env, val_envs = build(cfg, seed, **kw)
        shards = [build(cfg, seed, mesh=Mesh(n, 1, r, 0), sharded_feed=True)[1]
                  for r in range(n)]
        seq = []
        for _ in range(minibatches):
            for env in shards:
                env._next_minibatch()
                seq.extend(env.batch)
        train_env.data, train_env.ix = seq, 0
        return cfg, train_env, val_envs

    monkeypatch.setattr(finetune, "build_synthetic_dataset", joined)


@pytest.mark.parametrize("layout", [["--model_shards", "2"],
                                    ["--data_shards", "2", "--sharded_feed"]],
                         ids=["model_shards", "sharded_feed"])
def test_finetune_cli_trains_as_one_process(tmp_path, monkeypatch, layout):
    if "--sharded_feed" in layout:
        joined_shards(monkeypatch, 2)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = harness.finetune_for_parity(TINY + ["--output_dir", str(tmp_path / "one")])
    finally:
        torch.set_num_threads(threads)
    monkeypatch.undo()
    outs = harness.launch([harness.__file__, "finetune", *TINY, *layout,
                           "--output_dir", str(tmp_path / "two")], 2, RANK_TIMEOUT)
    got = [json.loads([ln for ln in o.splitlines() if ln.startswith("{")][-1])["best"]
           for o in outs]
    assert got[0] == got[1] and got[0].keys() == want.keys()
    for k, v in want.items():
        assert abs(got[0][k] - v) <= 1e-6 * max(1.0, abs(v)), k
    one = torch.load(tmp_path / "one" / "latest.pt", weights_only=True)
    two = torch.load(tmp_path / "two" / "latest.pt", weights_only=True)
    assert one["step"] == two["step"] == 2
    for part in ("model", "critic"):
        assert two[part].keys() == one[part].keys()
        for k, v in one[part].items():
            err = (two[part][k] - v).abs().max().item()
            assert err <= 1e-5 * v.abs().max().item() + 1e-7, (part, k, err)
