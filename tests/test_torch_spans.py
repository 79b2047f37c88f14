"""The port's spans and counters (``utils/logging.py``): the closed
recorder's no-op, nesting and self times, the spans and counters of one
merged ``sample`` update and of one device-rollout evaluation on the tiny
world (``tiny_world``'s sizes, built by the port's fixtures), the
profiler's clock, updates left bit-identical, and the fine-tuning CLI's
``span/`` and ``count/`` keys. CPU only; no JAX."""

import json

import pytest
import torch

from vln_hamt_torch.agents.agent import HAMTAgent
from vln_hamt_torch.configs import HAMTConfig
from vln_hamt_torch.data.fixtures import make_synthetic_world
from vln_hamt_torch.env import ObsSpec, R2RNavEnv
from vln_hamt_torch.run import finetune
from vln_hamt_torch.utils import SpanRecorder, count, span
from vln_hamt_torch.utils import logging as log_mod

# the conftest's tiny_world, from the port's copy of the fixtures
WORLD = dict(num_scans=1, nodes_per_scan=12, num_items=8, feat_dim=32, seed=1)
UPDATE_PHASES = ["teacher_episode", "rollout_inputs", "forward", "optimizer", "backward",
                 "optimizer"]


@pytest.fixture(scope="module")
def world():
    return make_synthetic_world(**WORLD)


@pytest.fixture
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def tiny_agent(world, batch_size=3):
    """A merged-``sample`` agent over the world, feature table on, CPU."""
    feat_dim = world.feat_db.feat_dim
    max_deg = max(g.max_degree for g in world.graphs.values())
    model = {"hidden_size": 64, "num_attention_heads": 4, "intermediate_size": 128,
             "num_l_layers": 2, "num_x_layers": 2, "num_h_pano_layers": 1,
             "image_feat_size": feat_dim, "vocab_size": 30522, "max_action_steps": 20,
             "max_position_embeddings": 64}
    cfg = HAMTConfig().replace(
        model=model,
        env={"max_action_len": 6, "max_instr_len": 24, "max_candidates": max_deg,
             "image_feat_size": feat_dim},
        train={"batch_size": batch_size, "feedback": "sample"})
    spec = ObsSpec(max_candidates=max_deg, image_feat_size=feat_dim)
    env = R2RNavEnv(world.graphs, world.feat_db, world.instr_data, spec,
                    batch_size=batch_size, max_instr_len=24, max_action_len=6, seed=0)
    agent = HAMTAgent(cfg, env, seed=0, device="cpu")
    agent.enable_feature_table()
    agent.merged_sample_update = True
    return agent


class _Clock:
    """A stand-in for the ``time`` module: both clocks read ``now``."""

    def __init__(self):
        self.now = 0

    def perf_counter_ns(self):
        return self.now

    def time_ns(self):
        return 10**18 + self.now


class _NoClock:
    def __getattr__(self, name):
        raise AssertionError(f"time.{name} read with no recorder open")


def test_closed_recorder_is_a_no_op(world, one_thread, monkeypatch):
    """With no recorder open, span and sync_span return the shared no-op
    and count returns at once: an update reads no clock, opens no
    record_function and reads no allocator statistics, and a recorder
    opened afterwards holds nothing."""
    agent = tiny_agent(world)

    def refuse(*a, **k):
        raise AssertionError("called with no recorder open")

    assert span("x") is log_mod.NO_SPAN and log_mod.sync_span() is log_mod.NO_SPAN
    assert log_mod.allocator_counts(torch.device("cuda")) is log_mod.NO_SPAN
    with monkeypatch.context() as m:
        m.setattr(log_mod, "time", _NoClock())
        m.setattr(torch.profiler, "record_function", refuse)
        m.setattr(torch.cuda, "memory_stats", refuse)
        assert count("syncs") is None
        agent.train_iteration(sync=True)
        agent.eval_split_device()
    with SpanRecorder(keep=True) as rec:
        pass
    assert rec.records == [] and not rec.stats and not rec.counters and not rec.roots


def test_nested_spans_parent_links_and_self_times(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(log_mod, "time", clock)
    with SpanRecorder(keep=True) as rec:
        count("loose", 2)  # outside every span: root ""
        a = span("a")
        a.__enter__()
        clock.now = 10
        with span("b"):
            clock.now = 20
            with span("c"):
                count("n", 3)
                clock.now = 30
            clock.now = 40
        clock.now = 50
        with span("d"):
            clock.now = 60
        clock.now = 100
        a.__exit__(None, None, None)
        with span("a"):
            count("n")
            clock.now = 105
    got = [(r.name, r.parent, r.root, r.start_ns, r.end_ns) for r in rec.records]
    assert got == [("a", -1, 0, 0, 100), ("b", 0, 0, 10, 40), ("c", 1, 0, 20, 30),
                   ("d", 0, 0, 50, 60), ("a", -1, 4, 100, 105)]
    # self time: the span less what its children cover
    assert rec.stats[("a", "a")] == [2, 105, 60 + 5]
    assert rec.stats[("a", "b")] == [1, 30, 20]
    assert rec.stats[("a", "c")] == [1, 10, 10]
    assert rec.stats[("a", "d")] == [1, 10, 10]
    assert dict(rec.counters) == {("", "loose"): 2, ("a", "n"): 4}
    assert rec.root_counters == {0: {"n": 3}, 4: {"n": 1}}
    assert dict(rec.roots) == {"a": 2}
    n, stats, counters = rec.per_root("a")
    assert n == 2 and stats["b"] == [1, 30, 20] and counters == {"n": 4}
    assert rec.to_profiler_ns(40) == 10**18 + 40
    with SpanRecorder():
        with pytest.raises(RuntimeError, match="already open"):
            with rec:
                pass


def _shipped(agent):
    """Wraps the update's two host-to-device steps to keep what they
    produced on the device."""
    shipped = []
    teacher, rollout_args = agent._teacher_episode, agent._device_rollout_args

    def note_teacher():
        ep = teacher()
        shipped.append(("teacher", list(ep.values())))
        return ep

    def note_args(*a, **k):
        ins = rollout_args(*a, **k)
        shipped.append(("rollout", [v for k_, v in ins.items() if k_ != "task_inputs"]
                        + list(ins.get("task_inputs", {}).values())))
        return ins

    agent._teacher_episode, agent._device_rollout_args = note_teacher, note_args
    return shipped


@pytest.mark.parametrize("sync", [False, True], ids=["async", "sync"])
def test_merged_update_spans_and_counters(world, one_thread, sync):
    """One merged sample update: one train_iteration root with the
    table's phases in order; a sync span inside the phase of each copy
    to the device and of each read back; syncs and h2d_bytes as the
    update's own blocking points and arrays."""
    agent = tiny_agent(world)
    shipped = _shipped(agent)
    with SpanRecorder(keep=True) as rec:
        out = agent.train_iteration(sync=sync)
    recs = rec.records
    assert recs[0].name == "train_iteration" and recs[0].parent == -1
    assert all(r.root == 0 for r in recs)
    children = [(i, r.name) for i, r in enumerate(recs) if r.parent == 0]
    reads = [name for _, name in children if name == "sync"]
    assert [name for _, name in children if name != "sync"] == UPDATE_PHASES
    phase_of = dict(children)
    copies = {}
    for r in recs:
        if r.name == "sync" and r.parent != 0:
            copies[phase_of[r.parent]] = copies.get(phase_of[r.parent], 0) + 1
    tensors = dict(shipped)
    assert copies == {"teacher_episode": len(tensors["teacher"]),
                      "rollout_inputs": len(tensors["rollout"])}
    # with sync the loss and each part are read back at the end
    assert len(reads) == (len(out) if sync else 0)
    n_sync = sum(r.name == "sync" for r in recs)
    assert n_sync == len(tensors["teacher"]) + len(tensors["rollout"]) + len(reads)
    assert rec.counters[("train_iteration", "syncs")] == n_sync
    assert rec.counters[("train_iteration", "h2d_bytes")] == sum(
        t.nbytes for _, ts in shipped for t in ts)
    assert ("train_iteration", "allocator_calls") not in rec.counters  # CPU
    for r in recs:
        assert r.start_ns <= r.end_ns
        if r.parent >= 0:
            p = recs[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns


def test_eval_split_device_spans(world, one_thread):
    """One device-rollout evaluation: one eval_split_device root and, per
    batch, rollout_inputs, rollout and decode in order, each read back a
    sync span inside decode."""
    agent = tiny_agent(world)
    batches = []
    decode = agent._decode_device_trajectories

    def note_decode(env, ep, extras):
        batches.append(len(ep))
        return decode(env, ep, extras)

    agent._decode_device_trajectories = note_decode
    with SpanRecorder(keep=True) as rec:
        preds = agent.eval_split_device()
    assert len(preds) == len(world.instr_data)
    recs = rec.records
    assert recs[0].name == "eval_split_device" and [r.root for r in recs] == [0] * len(recs)
    top = [r.name for r in recs if r.parent == 0]
    assert top == ["rollout_inputs", "rollout", "decode"] * len(batches)
    decodes = [i for i, r in enumerate(recs) if r.name == "decode"]
    for i in decodes:
        assert sum(r.parent == i and r.name == "sync" for r in recs) == 6
    assert rec.per_root("eval_split_device")[0] == 1


def test_span_on_the_profiler_clock(one_thread):
    """Under a CPU torch.profiler a span opens a record_function of its
    name; to_profiler_ns puts the span's start and end within 100 us of
    that event's."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(256, 256)
    with SpanRecorder(keep=True) as rec:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for name in ("warm", "warm", "probe"):  # the first annotation runs cold
                with span(name):
                    (x @ x).sum()
    probe = rec.records[-1]
    assert probe.name == "probe"
    event = [e for e in prof.profiler.kineto_results.events() if e.name() == "probe"]
    assert len(event) == 1
    assert abs(rec.to_profiler_ns(probe.start_ns) - event[0].start_ns()) < 100_000
    assert abs(rec.to_profiler_ns(probe.end_ns) - event[0].end_ns()) < 100_000


def test_open_recorder_leaves_updates_bit_identical(world, one_thread):
    """The same update with a keep=True recorder open and without: the
    same losses, weights and greedy trajectories, bit for bit."""
    runs = []
    for keep in (None, True):
        agent = tiny_agent(world)
        if keep is None:
            outs = [agent.train_iteration(sync=True) for _ in range(2)]
            preds = agent.eval_split_device()
        else:
            with SpanRecorder(keep=keep):
                outs = [agent.train_iteration(sync=True) for _ in range(2)]
                preds = agent.eval_split_device()
        runs.append((outs, {k: v.clone() for k, v in agent.model.state_dict().items()},
                     {k: v.clone() for k, v in agent.critic.state_dict().items()}, preds))
    (o1, m1, c1, p1), (o2, m2, c2, p2) = runs
    assert o1 == o2 and p1 == p2
    assert all(torch.equal(m1[k], m2[k]) for k in m1)
    assert all(torch.equal(c1[k], c2[k]) for k in c1)


def test_cli_logs_spans_and_counters_per_update(tmp_path, one_thread):
    """The fine-tuning CLI's interval lines carry each phase's mean self
    time per update (span/<name>_ms) and each counter per update
    (count/<name>)."""
    finetune.main(["--task", "r2r", "--synthetic", "--tiny", "--cpu", "--iters", "2",
                   "--log_every", "1", "--output_dir", str(tmp_path)])
    lines = [json.loads(x) for x in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    timed = [r for r in lines if "time/train" in r]
    assert len(timed) == 2
    for r in timed:
        for name in ["train_iteration"] + UPDATE_PHASES + ["sync"]:
            assert r[f"span/{name}_ms"] >= 0.0
        assert r["count/syncs"] == 16.0 and r["count/h2d_bytes"] > 0
        assert not any(k.startswith("span/") and "eval" in k for k in r)
