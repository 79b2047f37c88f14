"""The R2R-family slice end to end on the CPU against the JAX package:
``finetune.main(["--valid_only", "--tiny", "--cpu", "--init_ref_ckpt",
...])`` of both packages over the reference-format files of a fixture
world, and over ``--synthetic`` r2r_last, r4r and rxr worlds, give the
same trajectories and metrics within 1e-6; a tiny training run with
``--aug --eval_first`` alternates GT and aug batches in the JAX order
and writes ``metrics.jsonl`` under the JAX run's keys; ``--resume_file``
evaluates the checkpoint it wrote; and ``analytic_update_flops`` equals
the JAX package's for every R2R-family preset. Set-up from
tests/test_torch_train.py (one thread, the JAX init under jit)."""

import json
import warnings

import numpy as np
import pytest
import torch

from test_torch_checkpoints import write_agent_ckpt
from test_torch_train import train_test_setup  # noqa: F401 (autouse fixture)
from vln_hamt_tpu.configs import get_preset as jax_get_preset
from vln_hamt_tpu.env import R2RNavEnv as JaxEnv
from vln_hamt_tpu.run import finetune as jax_finetune
from vln_hamt_tpu.utils.flops import analytic_update_flops as jax_flops
from vln_hamt_torch.configs import get_preset
from vln_hamt_torch.data.fixtures import export_real_format, make_synthetic_world
from vln_hamt_torch.env import R2RNavEnv
from vln_hamt_torch.models.hamt import init_hamt
from vln_hamt_torch.run import finetune
from vln_hamt_torch.utils.flops import analytic_update_flops, chip_peak_flops, update_flops_and_peak

# the model of both CLIs' --tiny
TINY_MODEL = {"hidden_size": 64, "num_attention_heads": 4, "intermediate_size": 128,
              "num_l_layers": 2, "num_x_layers": 1, "num_h_pano_layers": 1,
              "image_feat_size": 32, "max_position_embeddings": 128, "max_action_steps": 32}
METRIC_ATOL = 1e-6


def reference_checkpoint(task, path, seed=11):
    """An agent-format reference checkpoint of the task's --tiny model,
    from a seeded port model with non-trivial [CLS] and LayerNorm terms."""
    cfg = get_preset(task).replace(model=TINY_MODEL).model
    model, critic = init_hamt(cfg, seed=seed)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    write_agent_ckpt(path, model, critic)
    return path


def jax_main(argv, capsys):
    """The JAX CLI's main, and the JSON object it printed last."""
    capsys.readouterr()
    jax_finetune.main(argv)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("task", ["r2r_files", "r2r_last", "r4r", "rxr"])
def test_valid_only_matches_jax(tmp_path, capsys, task):
    if task == "r2r_files":
        files = export_real_format(make_synthetic_world(num_scans=2, nodes_per_scan=16,
                                                        num_items=20, feat_dim=32, seed=4),
                                   str(tmp_path / "data"))
        task, data = "r2r", ["--anno_dir", files["anno_dir"], "--connectivity_dir",
                             files["connectivity_dir"], "--img_ft_file", files["img_ft_file"]]
    else:
        data = ["--synthetic"]
    ckpt = reference_checkpoint(task, str(tmp_path / "ref.pt"))
    argv = ["--task", task, "--valid_only", "--tiny", "--cpu", "--submit",
            "--init_ref_ckpt", ckpt] + data
    want = jax_main(argv + ["--output_dir", str(tmp_path / "jax")], capsys)["valid"]
    got = finetune.main(argv + ["--output_dir", str(tmp_path / "port")])
    assert got.keys() == want.keys() and got
    for split in want:
        assert got[split].keys() == want[split].keys()
        for k in want[split]:
            assert abs(got[split][k] - want[split][k]) <= METRIC_ATOL, (split, k)
    subs = sorted(p.name for p in (tmp_path / "jax").glob("submit_*.json"))
    assert subs == sorted(p.name for p in (tmp_path / "port").glob("submit_*.json")) and subs
    for name in subs:
        jt = json.loads((tmp_path / "jax" / name).read_text())
        pt = json.loads((tmp_path / "port" / name).read_text())
        assert [p["instr_id"] for p in pt] == [p["instr_id"] for p in jt]
        for p, j in zip(pt, jt):
            assert [v for v, _, _ in p["trajectory"]] == [v for v, _, _ in j["trajectory"]]
            np.testing.assert_allclose(np.array([t[1:] for t in p["trajectory"]]),
                                       np.array([t[1:] for t in j["trajectory"]]), atol=1e-6)
    assert "skipped" not in (tmp_path / "port" / "valid.txt").read_text()


def _record_env_order(monkeypatch, env_cls):
    order = []
    original = env_cls.teacher_episode

    def teacher_episode(self):
        order.append(self.name)
        return original(self)

    monkeypatch.setattr(env_cls, "teacher_episode", teacher_episode)
    return order


def test_cli_training_with_aug_and_eval_first(tmp_path, capsys, monkeypatch):
    """GT and aug batches alternate within an interval as in the JAX CLI,
    eval_first records each split before training, metrics.jsonl carries
    the JAX run's keys line for line (mfu is null on the CPU), and
    --resume_file --valid_only evaluates the checkpoint it wrote."""
    argv = ["--task", "r2r", "--synthetic", "--tiny", "--cpu", "--aug", "x", "--eval_first",
            "--feedback", "teacher", "--iters", "4", "--log_every", "4"]
    jorder = _record_env_order(monkeypatch, JaxEnv)
    order = _record_env_order(monkeypatch, R2RNavEnv)
    jax_main(argv + ["--output_dir", str(tmp_path / "jax")], capsys)
    best = finetune.main(argv + ["--output_dir", str(tmp_path / "port")])
    assert order == jorder == ["train", "aug", "train", "aug"]

    def records(run):
        return [json.loads(ln) for ln in (tmp_path / run / "metrics.jsonl").read_text()
                .splitlines()]

    got, want = records("port"), records("jax")
    # the port's timers line also carries its spans and counters per update
    extra = [{k for k in r if k.startswith(("span/", "count/"))} for r in got]
    assert [set(r) - e for r, e in zip(got, extra)] == [set(r) for r in want] and len(got) == 3
    assert [bool(e) for e in extra] == [False, False, True]
    assert got[0]["mfu"] is None and got[0]["eps_per_sec"] > 0
    assert np.isfinite(got[0]["loss"])
    for run in ("port", "jax"):
        assert "eval_first val_unseen: {" in (tmp_path / run / "train.txt").read_text()

    results = finetune.main(["--task", "r2r", "--synthetic", "--tiny", "--cpu", "--valid_only",
                             "--resume_file", str(tmp_path / "port" / "latest.pt"),
                             "--output_dir", str(tmp_path / "valid")])
    last = got[1]
    for k, v in results["val_unseen"].items():
        assert v == pytest.approx(last[f"val_unseen/{k}"], abs=METRIC_ATOL), k
    assert best["iter"] == 4
    assert "loaded" in (tmp_path / "valid" / "valid.txt").read_text()


@pytest.mark.parametrize("task", ["r2r", "r2r_last", "r4r", "rxr", "reverie"])
@pytest.mark.parametrize("lanes", [8, 16])
def test_analytic_update_flops_matches_jax(task, lanes):
    """The count of every R2R-family preset and REVERIE's, whose visual
    stream carries the viewpoint's object tokens."""
    n_ob = 14 + 1 + 36
    cfg = get_preset(task)
    n_obj = cfg.env.max_objects if cfg.model.obj_feat_size > 0 else 0
    assert analytic_update_flops(cfg, lanes, n_ob, n_obj) == \
        jax_flops(jax_get_preset(task), lanes, n_ob, n_obj=n_obj)


@pytest.mark.parametrize("task", ["r2r", "reverie"])
@pytest.mark.parametrize("world", [1, 2])
def test_cli_mfu_terms_match_jax(task, world):
    """The fine-tune CLI's MFU terms are the JAX CLI's
    (vln_hamt_tpu/run/finetune.py:410-416): the FLOPs of one update of the
    global batch with REVERIE's object tokens, over one card's peak times
    the number of cards."""
    jcfg = jax_get_preset(task)
    n_ob = jcfg.env.max_candidates + 1 + 36
    n_obj = jcfg.env.max_objects if jcfg.model.obj_feat_size > 0 else 0
    lanes = jcfg.train.batch_size * (2 if jcfg.train.feedback == "sample" else 1)
    flops, peak = update_flops_and_peak(get_preset(task), "NVIDIA H100 80GB HBM3", world)
    assert flops == jax_flops(jcfg, lanes, n_ob, n_obj=n_obj)
    assert peak == 989e12 * world
    assert update_flops_and_peak(get_preset(task), None, world) == (flops, None)


def test_unknown_card_logs_null_mfu():
    """A card the peak table does not hold gives no peak, hence a null
    mfu, and one warning, not an error; the H100's other parts are known."""
    cfg = get_preset("r2r")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert update_flops_and_peak(cfg, "NVIDIA A100-SXM4-80GB", 1)[1] is None
        assert update_flops_and_peak(cfg, "NVIDIA A100-SXM4-80GB", 2)[1] is None
    assert len(caught) == 1 and "A100" in str(caught[0].message)
    assert update_flops_and_peak(cfg, "NVIDIA H100 PCIe", 1)[1] == 756e12
    assert update_flops_and_peak(cfg, "NVIDIA H100 NVL", 1)[1] == 835e12


def test_chip_peak_flops_knows_the_h100_only():
    assert chip_peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    with pytest.raises(KeyError, match="TPU v5 lite"):
        chip_peak_flops("TPU v5 lite")
