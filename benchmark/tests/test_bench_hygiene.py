"""The benchmark's hygiene: what its processes load, and that a new
configuration, cell and metric are found by name with no edit."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

from benchmark import run

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = ("jax", "jaxlib", "flax", "vln_hamt_tpu")


def _loaded(imports: str) -> list:
    code = (f"import sys\n{imports}\n"
            "print('\\n'.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    return out.stdout.split()


def test_the_harness_loads_no_jax():
    tops = _loaded("import benchmark.run, benchmark.control, benchmark.trace\n"
                   "import benchmark.entries.finetune, benchmark.entries.eval_greedy\n"
                   "import vln_hamt_torch.agents.agent, vln_hamt_torch.run.finetune")
    assert "vln_hamt_torch" in tops
    assert not [m for m in tops if m in FORBIDDEN]
    assert run.forbidden_modules() == [] or "jax" in sys.modules  # this process may hold them


def test_the_reference_loads_nothing_of_the_program():
    tops = _loaded("import benchmark.reference.hamt, benchmark.reference.finetune\n"
                   "import benchmark.reference.evaluate, benchmark.reference.navigation\n"
                   "import benchmark.reference.dropout, benchmark.world.generator\n"
                   "import benchmark.work.flops, benchmark.work.attention")
    assert "vln_hamt_torch" not in tops
    assert not [m for m in tops if m in FORBIDDEN]


def test_forbidden_names_compare_whole():
    sys.modules.setdefault("vln_hamt_tpu_lookalike_x", type(sys)("vln_hamt_tpu_lookalike_x"))
    try:
        assert "vln_hamt_tpu_lookalike_x" not in run.forbidden_modules()
    finally:
        del sys.modules["vln_hamt_tpu_lookalike_x"]


def test_new_files_are_found_by_name(tmp_path):
    bench = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark", bench, ignore=shutil.ignore_patterns("__pycache__"))
    config = json.loads((bench / "configs" / "r2r.json").read_text())
    config["name"] = "r2r_wide"
    (bench / "configs" / "r2r_wide.json").write_text(json.dumps(config))
    cell = json.loads((bench / "cells" / "r2r.eval_greedy.json").read_text())
    cell.update(config="r2r_wide", batch=16)
    (bench / "cells" / "r2r_wide.eval_greedy.json").write_text(json.dumps(cell))
    (bench / "metrics" / "kernels_per_unit.eval.py").write_text(
        "def read(s):\n    return s['launches'] / s['units']\n")
    c, cfg = run.load_cell("r2r_wide.eval_greedy", bench)
    assert (c["batch"], cfg["name"]) == (16, "r2r_wide")
    reader = run.load_reader("kernels_per_unit.eval", bench)
    assert reader.read({"launches": 10, "units": 4}) == 2.5
    manifest = {"end_to_end": [{"name": "setup_s"},
                               {"name": "eval_episodes_per_s", "workloads": ["r2r.eval_greedy"]}],
                "per_layer": [{"name": "kernels_per_unit.eval",
                               "workloads": ["r2r_wide.eval_greedy"]}]}
    e2e, per_layer = run.manifest_metrics(manifest, "r2r_wide.eval_greedy")
    assert [m["name"] for m in e2e] == ["setup_s"]
    assert [m["name"] for m in per_layer] == ["kernels_per_unit.eval"]


def test_the_run_refuses_without_a_card():
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "r2r.eval_greedy", "--seed", "2147483649", "--seconds", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert not [ln for ln in out.stdout.splitlines() if ln.startswith("{")]


def test_the_manifest_names_existing_files():
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in m["configs"]:
        assert (ROOT / c["file"]).exists()
    for w in m["workloads"]:
        cell = json.loads((ROOT / "benchmark" / "cells" / f"{w['name']}.json").read_text())
        assert cell["config"] == w["config"] and int(cell["chips"]) == w["chips"]
    for p in m["per_layer"]:
        assert (ROOT / "benchmark" / "metrics" / f"{p['name']}.py").exists()
        assert set(p["workloads"]) <= {w["name"] for w in m["workloads"]}
