"""The three CLIs as two rank processes (gloo on the CPU, the ranks'
variables as torchrun sets them, each rank with a timeout), tiny sizes:
fine-tuning with ``--data_shards 2`` gives the one-process run's metrics
(at learning rate 0, so that the per-rank dropout leaves the weights
alone) and rank 0 alone writes; ``--orbax_ckpt`` directory checkpoints
resume under two ranks; pretraining and image pretraining take two
updates with ``--data_shards 2`` and write one checkpoint in the
one-rank layout."""

import importlib.util
import json
import os

import torch

from test_torch_parallel import RANK_TIMEOUT
from torch_parallel_harness import launch
from vln_hamt_torch.run import finetune

TINY = ["--synthetic", "--tiny", "--cpu"]


def ranks(module: str, argv, n: int = 2) -> list:
    """The last JSON line each rank of ``python -m module argv`` printed."""
    outs = launch(["-m", f"vln_hamt_torch.run.{module}", *argv], n, RANK_TIMEOUT)
    return [json.loads([ln for ln in o.splitlines() if ln.startswith("{")][-1]) for o in outs]


def one_thread(fn):
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn()
    finally:
        torch.set_num_threads(prev)


def test_finetune_two_ranks_match_one_process(tmp_path):
    argv = TINY + ["--iters", "2", "--log_every", "2", "--lr", "0"]
    want = one_thread(lambda: finetune.main(argv + ["--output_dir", str(tmp_path / "one")]))
    got = ranks("finetune", argv + ["--data_shards", "2", "--output_dir", str(tmp_path / "two")])
    assert got[0]["best"] == got[1]["best"]
    assert got[0]["best"].keys() == want.keys()
    for k, v in want.items():
        assert abs(got[0]["best"][k] - v) <= 1e-6 * max(1.0, abs(v)), k
    for name in ("metrics.jsonl", "train.txt"):  # rank 0 wrote each line once
        with open(tmp_path / "one" / name) as a, open(tmp_path / "two" / name) as b:
            assert len(a.readlines()) == len(b.readlines()), name
    assert sorted(os.listdir(tmp_path / "two")) == sorted(os.listdir(tmp_path / "one"))


def test_orbax_checkpoints_resume_under_two_ranks(tmp_path):
    """One process writes directory checkpoints (asynchronously); two data
    ranks evaluate the directory as the one process does and resume
    training from it, writing their own directory together, which one
    process loads."""
    one = str(tmp_path / "one")
    one_thread(lambda: finetune.main(TINY + ["--iters", "2", "--log_every", "2",
                                             "--orbax_ckpt", "--output_dir", one]))
    assert {"latest", "best_val_unseen"} <= set(os.listdir(one))
    assert not any(n.endswith(".pt") for n in os.listdir(one))
    latest = os.path.join(one, "latest")
    want = one_thread(lambda: finetune.main(TINY + ["--valid_only", "--resume_file", latest,
                                                    "--output_dir", str(tmp_path / "v1")]))
    got = ranks("finetune", TINY + ["--valid_only", "--resume_file", latest, "--data_shards",
                                    "2", "--output_dir", str(tmp_path / "v2")])
    for k, v in want["val_unseen"].items():
        assert abs(got[0]["valid"]["val_unseen"][k] - v) <= 1e-6 * max(1.0, abs(v)), k
    two = str(tmp_path / "two")
    ranks("finetune", TINY + ["--iters", "2", "--log_every", "2", "--orbax_ckpt",
                              "--resume_file", latest, "--data_shards", "2",
                              "--output_dir", two])
    cfg, _, val_envs = finetune.build_synthetic_dataset(finetune.get_preset("r2r").replace(
        model={"hidden_size": 64, "num_attention_heads": 4, "intermediate_size": 128,
               "num_l_layers": 2, "num_x_layers": 1, "num_h_pano_layers": 1,
               "image_feat_size": 32, "max_position_embeddings": 128, "max_action_steps": 32},
        env={"max_action_len": 8, "max_instr_len": 32, "image_feat_size": 32},
        train={"batch_size": 4}))
    agent = finetune.HAMTAgent(cfg, None, device="cpu")
    # resumed at step 2, two more updates
    assert agent.load(os.path.join(two, "latest"), resume_optimizer=True) == 4


def test_pretrain_clis_two_ranks(tmp_path):
    """run/pretrain.py (replicated feed) and run/image_pretrain.py (sharded
    feed) take two updates on two data ranks; one checkpoint each, in the
    one-rank layout."""
    for module, extra in (("pretrain", ["--batch_size", "4"]),
                          ("image_pretrain", ["--batch_size", "2", "--sharded_feed"])):
        out = str(tmp_path / module)
        got = ranks(module, ["--tiny", "--synthetic", "--cpu", "--num_steps", "2",
                             "--valid_steps", "2", "--data_shards", "2", "--output_dir", out,
                             *extra])
        assert got == [{"final_step": 2}] * 2
        # the run's config record, and the metrics' TensorBoard mirror
        # where tensorboardX imports (utils/logging.py:MetricsLogger)
        tb = ["tb"] if importlib.util.find_spec("tensorboardX") else []
        assert sorted(os.listdir(out)) == sorted(["metrics.jsonl", "model_step_2.pt",
                                                  "training_config.json", *tb])
        blob = torch.load(os.path.join(out, "model_step_2.pt"), weights_only=True)
        assert blob["step"] == 2 and any(k.startswith("bert.") for k in blob)
