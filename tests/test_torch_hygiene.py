"""Package rules of the port: it imports nothing of JAX or of the JAX
package, and its entry points never fall back to the CPU on their own."""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from vln_hamt_torch.agents.agent import HAMTAgent, resolve_device
from vln_hamt_torch.configs import get_preset
from vln_hamt_torch.run import finetune, image_pretrain, precompute_features
from vln_hamt_torch.run import pretrain

ROOT = Path(__file__).resolve().parent.parent
BANNED = {"jax", "jaxlib", "flax", "optax", "orbax", "vln_hamt_tpu"}


def _port_sources():
    return sorted((ROOT / "vln_hamt_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


# the vision slice's modules, each a port of a JAX package module
VISION_MODULES = ("native/navsim.py", "vision/transforms.py", "vision/vit.py",
                  "vision/featurizer.py", "models/convert.py", "run/precompute_features.py",
                  "run/build_image_store.py", "pretrain/image_data.py",
                  "pretrain/image_model.py", "pretrain/trainer.py", "run/image_pretrain.py")


def test_port_imports_no_jax():
    files = _port_sources()
    assert len(files) > 20
    assert {ROOT / "vln_hamt_torch" / m for m in VISION_MODULES} <= set(files)
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}:{node.lineno} {n}"
                    for n in names if n.split(".")[0] in BANNED]
    assert not bad, bad


def test_entry_points_need_a_card_unless_asked_for_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    cfg = get_preset("r2r")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HAMTAgent(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        finetune.main(["--valid_only", "--synthetic", "--tiny",
                       "--output_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pretrain.main(["--synthetic", "--tiny", "--output_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        image_pretrain.main(["--synthetic", "--tiny", "--output_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        precompute_features.main(["--synthetic", "1", "--output_file",
                                  str(tmp_path / "f.hdf5")])
    assert resolve_device("cpu") == torch.device("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


@pytest.fixture
def one_thread():
    """One torch thread: the CLI runs below share the test workers' cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# the flags of the JAX CLI that the port ran last (activation
# recomputation, the dropout-PRNG name), each with a value; none is left
# unported
PORTED_LAST = {"remat": [], "remat_policy": ["dots"], "rng_impl": ["rbg"]}
UNPORTED = {}


@pytest.mark.parametrize("argv", [["--synthetic", f"--{flag}"] + value
                                  for flag, value in PORTED_LAST.items()],
                         ids=list(PORTED_LAST))
def test_cli_names_the_roadmap_item_of_unported_paths(argv, tmp_path, one_thread):
    """Each flag that once raised its ROADMAP item now runs: one tiny IL
    update on the CPU, the flag in the run's config record."""
    out = tmp_path / "run"
    finetune.main(argv + ["--cpu", "--tiny", "--feedback", "teacher", "--iters", "1",
                          "--log_every", "1", "--output_dir", str(out)])
    rec = json.loads((out / "training_config.json").read_text())
    flag = argv[1][2:]
    part = "train" if flag == "rng_impl" else "model"
    assert rec[part][flag] == (argv[2] if len(argv) > 2 else True)


def test_cli_flags_cover_the_jax_cli():
    """The port's parser takes every flag of the JAX CLI's."""
    from vln_hamt_tpu.run import finetune as jax_finetune

    assert vars(finetune.parse_args([])).keys() == vars(jax_finetune.parse_args([])).keys()
    assert set(UNPORTED) == set(finetune._UNPORTED_FLAGS)


# the JAX pretraining CLIs' flags that the port ran last; none is left
PRETRAIN_PORTED_LAST = {"rng_impl": ["rbg"]}
PRETRAIN_UNPORTED = {}


def _pretrain_run(main, argv, tmp_path):
    out = tmp_path / "run"
    assert main(argv + ["--cpu", "--tiny", "--num_steps", "1", "--valid_steps", "1",
                        "--output_dir", str(out)])["final_step"] == 1
    return json.loads((out / "training_config.json").read_text())


@pytest.mark.parametrize("argv", [["--synthetic", f"--{flag}"] + value
                                  for flag, value in PRETRAIN_PORTED_LAST.items()],
                         ids=list(PRETRAIN_PORTED_LAST))
def test_pretrain_cli_names_the_roadmap_item_of_unported_flags(argv, tmp_path, one_thread):
    """The flag that once raised its ROADMAP item now runs: one tiny
    pretraining step on the CPU, the name in the run's config record."""
    rec = _pretrain_run(pretrain.main, argv + ["--batch_size", "2"], tmp_path)
    assert rec["args"]["rng_impl"] == "rbg"


# the JAX image pretraining CLI's flags that the port ran last; none is left
IMAGE_PRETRAIN_PORTED_LAST = {"rng_impl": ["rbg"]}
IMAGE_PRETRAIN_UNPORTED = {}


@pytest.mark.parametrize("argv", [["--synthetic", f"--{flag}"] + value
                                  for flag, value in IMAGE_PRETRAIN_PORTED_LAST.items()],
                         ids=list(IMAGE_PRETRAIN_PORTED_LAST))
def test_image_pretrain_cli_names_the_roadmap_item_of_unported_flags(argv, tmp_path,
                                                                     one_thread):
    """The flag that once raised its ROADMAP item now runs: one tiny e2e
    pretraining step on the CPU, the name in the run's config record."""
    rec = _pretrain_run(image_pretrain.main, argv, tmp_path)
    assert rec["args"]["rng_impl"] == "rbg"


def test_image_pretrain_cli_flags_cover_the_jax_cli():
    """The port's image pretraining parser takes every flag of the JAX
    CLI's, and --cpu; file-backed runs need their files and a store."""
    from vln_hamt_tpu.run import image_pretrain as jax_image_pretrain

    assert (vars(image_pretrain.parse_args([])).keys()
            == vars(jax_image_pretrain.parse_args([])).keys() | {"cpu"})
    assert set(IMAGE_PRETRAIN_UNPORTED) == set(image_pretrain._UNPORTED_FLAGS)
    with pytest.raises(ValueError, match="--lmdb_path or --npy_dir"):
        image_pretrain.main(["--cpu"])


def test_pretrain_cli_flags_cover_the_jax_cli():
    """The port's pretraining parser takes every flag of the JAX CLI's,
    and --cpu."""
    from vln_hamt_tpu.run import pretrain as jax_pretrain

    assert vars(pretrain.parse_args([])).keys() == vars(jax_pretrain.parse_args([])).keys() | {"cpu"}
    assert set(PRETRAIN_UNPORTED) == set(pretrain._UNPORTED_FLAGS)
    with pytest.raises(ValueError, match="--train_traj_files --img_ft_file"):
        pretrain.main(["--cpu"])


def test_cli_real_data_needs_its_files():
    with pytest.raises(ValueError, match="--anno_dir --connectivity_dir --img_ft_file"):
        finetune.main(["--valid_only", "--cpu"])


@pytest.mark.parametrize("mode", ["valid_only", "train"])
@pytest.mark.parametrize("task", ["r2r_back", "cvdn", "reverie"])
def test_cli_task_variants_on_cpu(tmp_path, task, mode):
    """Each task variant through the CLI at a tiny size on the CPU: greedy
    evaluation of the validation and test splits (--valid_only --submit:
    the task's metrics, and its extras in the submission file), or 2
    sample updates and an evaluation to the task's selection score."""
    argv = ["--task", task, "--synthetic", "--tiny", "--cpu", "--output_dir", str(tmp_path)]
    if mode == "valid_only":
        out = _one_thread(lambda: finetune.main(argv + ["--valid_only", "--submit"]))
        m = out["val_unseen"]
        submitted = json.loads((tmp_path / "submit_test.json").read_text())
        extra = {"r2r_back": "midstop", "reverie": "predObjId"}.get(task)
        assert submitted and all(extra in p for p in submitted) if extra else submitted
    else:
        m = _one_thread(lambda: finetune.main(argv + ["--iters", "2", "--log_every", "2"]))
        assert m["iter"] == 2
        assert m["score"] == finetune.selection_score(task, m)
    key = {"r2r_back": "nDTW", "cvdn": "gp", "reverie": "rgspl"}[task]
    assert 0.0 <= m["sr"] <= 100.0 and np.isfinite(m[key])


def test_cli_valid_only_on_cpu(tmp_path):
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        results = finetune.main(["--task", "r2r", "--valid_only", "--synthetic", "--tiny",
                                 "--cpu", "--submit", "--output_dir", str(tmp_path)])
    finally:
        torch.set_num_threads(prev)
    m = results["val_unseen"]
    assert 0.0 <= m["sr"] <= 100.0 and m["steps"] > 0
    assert (tmp_path / "valid.txt").exists()
    assert (tmp_path / "submit_test.json").exists()


def _one_thread(fn):
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn()
    finally:
        torch.set_num_threads(prev)


@pytest.mark.parametrize("argv", [
    ["--bf16"],
    ["--feedback", "teacher", "--packed_il"],
    ["--feedback", "teacher", "--packed_il", "--bf16", "--aug", "x"],
], ids=["bf16", "packed_il", "packed_il_bf16_aug"])
def test_cli_trains_bf16_and_packed_on_cpu(tmp_path, argv):
    """--bf16 (sample feedback) and --packed_il (teacher feedback, with
    GT/aug alternation) train end to end at a tiny size on the CPU."""
    best = _one_thread(lambda: finetune.main(
        ["--task", "r2r", "--synthetic", "--tiny", "--cpu", "--iters", "2", "--log_every", "2",
         "--output_dir", str(tmp_path)] + argv))
    assert best["iter"] == 2 and 0.0 <= best["sr"] <= 100.0
    logged = (tmp_path / "metrics.jsonl").read_text()
    assert '"eps_per_sec"' in logged


@pytest.mark.parametrize("argv,match", [
    (["--packed_il"], "teacher feedback only"),
    (["--packed_il", "--feedback", "sample"], "teacher feedback only"),
    (["--packed_il", "--feedback", "teacher", "--no_feat_table"], "requires the feature table"),
    (["--packed_il", "--feedback", "teacher", "--sharded_feed"], "with --sharded_feed"),
], ids=["preset_sample", "sample", "no_feat_table", "sharded_feed"])
def test_cli_packed_il_guards(tmp_path, argv, match):
    """--packed_il raises as the JAX CLI does: with sample feedback (the
    preset's), without the feature table and with the sharded feed."""
    with pytest.raises(ValueError, match=match):
        finetune.main(["--synthetic", "--tiny", "--cpu", "--output_dir", str(tmp_path)] + argv)


def test_pretrain_cli_bf16_on_cpu(tmp_path):
    out = _one_thread(lambda: pretrain.main(
        ["--synthetic", "--tiny", "--cpu", "--bf16", "--num_steps", "4", "--valid_steps", "2",
         "--batch_size", "4", "--output_dir", str(tmp_path)]))
    assert out["final_step"] == 4 and (tmp_path / "model_step_4.pt").exists()
    saved = torch.load(tmp_path / "model_step_4.pt", weights_only=True)
    # parameters stay fp32 under bf16 compute: the file is a reference checkpoint
    assert all(v.dtype == torch.float32 for k, v in saved.items()
               if k != "step" and v.is_floating_point())
