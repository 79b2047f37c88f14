"""Package rules of the port: it imports nothing of JAX or of the JAX
package, and its entry points never fall back to the CPU on their own."""

import ast
from pathlib import Path

import pytest
import torch

from vln_hamt_torch.agents.agent import HAMTAgent, resolve_device
from vln_hamt_torch.configs import get_preset
from vln_hamt_torch.run import finetune

ROOT = Path(__file__).resolve().parent.parent
BANNED = {"jax", "jaxlib", "flax", "optax", "orbax", "vln_hamt_tpu"}


def _port_sources():
    return sorted((ROOT / "vln_hamt_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_imports_no_jax():
    files = _port_sources()
    assert len(files) > 20
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
    assert resolve_device("cpu") == torch.device("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("argv", [
    ["--task", "rxr", "--valid_only", "--synthetic"],
    ["--synthetic", "--resume_file", "x.pt"],
    ["--valid_only"],
    ["--valid_only", "--synthetic", "--resume_file", "x.pkl"],
], ids=["task", "training", "real_data", "resume"])
def test_cli_names_the_roadmap_item_of_unported_paths(argv):
    with pytest.raises(NotImplementedError, match="ROADMAP item"):
        finetune.main(argv + ["--cpu"])


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
