"""The port's utilities against the JAX package's: the dropout-PRNG names
(``utils/misc.py:apply_rng_impl``), ``--rng_impl rbg`` through the
fine-tuning CLI's replay update, ``length_mask``, the metrics logger's
TensorBoard mirror, ``profile_trace`` and the trace breakdown
``utils/xprof.py`` on synthetic Chrome traces."""

import gzip
import json
import sys

import jax
import numpy as np
import pytest
import torch

from vln_hamt_tpu.utils.misc import apply_rng_impl as jax_apply_rng_impl
from vln_hamt_tpu.utils.misc import length_mask as jax_length_mask
from vln_hamt_torch.run import finetune
from vln_hamt_torch.utils import MetricsLogger, length_mask
from vln_hamt_torch.utils import xprof
from vln_hamt_torch.utils.logging import profile_trace
from vln_hamt_torch.utils.misc import apply_rng_impl


@pytest.fixture
def one_thread():
    """One torch thread: the CLI run below shares the test workers' cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def restore_prng_impl():
    prev = jax.config.jax_default_prng_impl
    yield
    jax.config.update("jax_default_prng_impl", prev)


@pytest.mark.parametrize("name", ["threefry2x32", "threefry", "rbg", "unsafe_rbg", "philox",
                                  "", "RBG"])
def test_apply_rng_impl_in_step_with_jax(restore_prng_impl, name):
    """The same names pass and fail as in the JAX package; each passing
    name comes back canonical (the one JAX's config then holds)."""
    try:
        jax_apply_rng_impl(name)
    except ValueError:
        with pytest.raises(ValueError, match="rng_impl"):
            apply_rng_impl(name)
        return
    assert apply_rng_impl(name) == jax.config.jax_default_prng_impl


def test_rbg_round_trips_through_the_replay_update(tmp_path, one_thread):
    """--rng_impl rbg: the fine-tuning CLI trains with rollout-then-replay
    sample updates (host-loop rollout, no feature table), which the JAX
    package refuses under rbg and the port's replayable streams take, and
    records the name."""
    out = tmp_path / "run"
    best = finetune.main(["--synthetic", "--tiny", "--cpu", "--rng_impl", "rbg",
                          "--no_feat_table", "--feedback", "sample", "--iters", "2",
                          "--log_every", "2", "--output_dir", str(out)])
    assert np.isfinite(best["score"])
    assert json.loads((out / "training_config.json").read_text())["train"]["rng_impl"] == "rbg"
    logged = [json.loads(x) for x in (out / "metrics.jsonl").read_text().splitlines()]
    assert any(np.isfinite(r.get("loss", np.nan)) for r in logged)


def test_length_mask_matches_jax():
    lengths = [0, 3, 7]
    np.testing.assert_array_equal(length_mask(lengths, 7), jax_length_mask(lengths, 7))


def test_metrics_logger_tensorboard_mirror(tmp_path, monkeypatch):
    """Numeric scalars go to metrics.jsonl and, where tensorboardX
    imports, to its event file under tb/; without it, the JSONL alone."""
    pytest.importorskip("tensorboardX")
    log = MetricsLogger(str(tmp_path / "with"))
    log.log(1, {"loss": 0.5, "note": "text", "n": 3})
    log.close()
    assert list((tmp_path / "with" / "tb").glob("events.out.tfevents*"))
    monkeypatch.setitem(sys.modules, "tensorboardX", None)  # import fails
    log = MetricsLogger(str(tmp_path / "without"))
    log.log(1, {"loss": 0.5})
    log.close()
    assert not (tmp_path / "without" / "tb").exists()
    rec = json.loads((tmp_path / "without" / "metrics.jsonl").read_text())
    assert rec["loss"] == 0.5 and rec["step"] == 1


def _kernel(name, ts, dur, pid=0, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": 7, "ts": ts, "dur": dur}


def _write_trace(path, events):
    trace = {"traceEvents": events + [
        # host-side events: never counted
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 1, "tid": 1, "ts": 0,
         "dur": 500},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1, "tid": 1,
         "ts": 1, "dur": 2},
        {"ph": "i", "cat": "kernel", "name": "instant", "pid": 0, "ts": 3}]}
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wt") as f:
        json.dump(trace, f)


def test_xprof_breaks_down_a_synthetic_trace(tmp_path, capsys):
    """Categories, launch counts, idle gaps and the top kernels of two
    trace files (plain and gzipped), two devices in one of them."""
    _write_trace(tmp_path / "a.pt.trace.json", [
        _kernel("void attention_fwd_kernel<64, 96, float>(Params)", 100, 10),
        _kernel("void attention_fwd_kernel<64, 96, float>(Params)", 110, 10),  # back to back
        _kernel("ampere_sgemm_128x64_nn", 125, 20),                            # gap 5
        _kernel("void attention_bwd_kernel<64, 96, float>(BwdParams)", 150, 30),  # gap 5
        _kernel("attention_bwd_reduce_kernel(BwdParams)", 170, 20),           # overlaps
        _kernel("Memcpy HtoD (Pageable -> Device)", 200, 4, cat="gpu_memcpy"),  # gap 10
        _kernel("nvjet_hsh_128x256", 0, 8, pid=1),                             # device 1
        _kernel("vectorized_elementwise_kernel", 18, 2, pid=1),               # gap 10
    ])
    (tmp_path / "sub").mkdir()
    _write_trace(tmp_path / "sub" / "b.pt.trace.json.gz", [
        _kernel("void attention_fwd_kernel<64, 96, float>(Params)", 0, 6)])
    (tmp_path / "training_config.json").write_text("[1, 2]")  # a JSON file that is no trace
    res = xprof.analyze(str(tmp_path), top=3)
    cats = {c["category"]: c for c in res["categories"]}
    assert {k: c["launches"] for k, c in cats.items()} == {
        "attention_fwd_kernel": 3, "attention_bwd_kernel": 2, "matmul": 2, "other": 2}
    assert {k: c["us"] for k, c in cats.items()} == {
        "attention_fwd_kernel": 26, "attention_bwd_kernel": 50, "matmul": 28, "other": 6}
    assert res["device_us"] == 110
    assert sum(c["share"] for c in cats.values()) == pytest.approx(1.0)
    # device 0 spans 100-204 busy 20 + 20 + 40 + 4; device 1 0-20 busy 10; b 0-6
    assert res["span_us"] == 104 + 20 + 6 and res["busy_us"] == 84 + 10 + 6
    assert res["idle_us"] == 30 and res["gaps"] == 4 and res["max_gap_us"] == 10
    assert res["idle_share"] == pytest.approx(30 / 130)
    assert [k["name"] for k in res["top"]] == [
        "void attention_bwd_kernel<64, 96, float>(BwdParams)",
        "void attention_fwd_kernel<64, 96, float>(Params)",
        "ampere_sgemm_128x64_nn"]
    assert res["top"][1]["launches"] == 3 and res["top"][1]["us"] == 26
    xprof.main([str(tmp_path), "--top", "2"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["metric"] == "xprof_device_busy_ms" and last["value"] == pytest.approx(0.1)
    assert last["categories"]["attention_bwd_kernel"]["launches"] == 2


def test_cpu_profile_trace_has_no_device_kernels(tmp_path):
    """profile_trace writes its Chrome trace on the CPU too; its breakdown
    refuses it (no device kernels) rather than reporting zeros; an empty
    directory has no trace at all."""
    with profile_trace(str(tmp_path / "trace")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = xprof.find_trace_files(str(tmp_path / "trace"))
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    assert any(e.get("cat") == "cpu_op" for e in xprof.load_trace(files[0])["traceEvents"])
    with pytest.raises(RuntimeError, match="no device kernels"):
        xprof.analyze(str(tmp_path / "trace"))
    with pytest.raises(FileNotFoundError):
        xprof.analyze(str(tmp_path / "empty"))
