"""``benchmark/spans.py`` on synthetic spans and device events: the
innermost span under way, idle under no span, the idle stretches at a
window's ends, parts that add up to the window's idle share, the
per-unit figures of a window, and the probe's span metrics."""

from __future__ import annotations

from collections import namedtuple

import pytest

from benchmark import spans

# a recorder's kept span (vln_hamt_torch.utils.logging.SpanRecord)
Rec = namedtuple("Rec", "name parent root start_ns end_ns")

# two updates: 0-100 and 120-200 (recorder clock); inside the first a
# teacher episode (10-40) with a copy's wait (30-40), the forward (40-70),
# the backward (70-90); inside the second a forward (130-190) with a wait
# (180-190)
RECORDS = [Rec("train_iteration", -1, 0, 0, 100), Rec("teacher_episode", 0, 0, 10, 40),
           Rec("sync", 1, 0, 30, 40), Rec("forward", 0, 0, 40, 70),
           Rec("backward", 0, 0, 70, 90), Rec("train_iteration", -1, 5, 120, 200),
           Rec("forward", 5, 5, 130, 190), Rec("sync", 6, 5, 180, 190)]
COUNTERS = {0: {"syncs": 1, "h2d_bytes": 64}, 5: {"syncs": 1}}


def test_timeline_takes_the_innermost_span():
    assert spans.timeline(RECORDS) == [
        (0, 10, "train_iteration"), (10, 30, "teacher_episode"), (30, 40, "sync"),
        (40, 70, "forward"), (70, 90, "backward"), (90, 100, "train_iteration"),
        (120, 130, "train_iteration"), (130, 180, "forward"), (180, 190, "sync"),
        (190, 200, "train_iteration")]


def test_spans_sharing_an_end_or_a_start_nest():
    recs = [Rec("a", -1, 0, 0, 10), Rec("b", 0, 0, 0, 10), Rec("c", 1, 0, 5, 10)]
    assert spans.timeline(recs) == [(0, 5, "b"), (5, 10, "c")]


def test_idle_is_charged_to_the_innermost_span_or_outside():
    # the profiler's clock runs 1000 ahead of the recorder's
    to_ns = lambda t: t + 1000  # noqa: E731
    idle = [(1005, 1015), (1035, 1045), (1095, 1125), (1185, 1210)]
    got = spans.idle_by_span(idle, RECORDS, to_ns)
    want = {"train_iteration": (5 + 5 + 5 + 10) / 1e9, "teacher_episode": 5 / 1e9,
            "sync": (5 + 5) / 1e9, "forward": 5 / 1e9, "outside": (20 + 10) / 1e9}
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-18)


def test_idle_stretches_include_the_window_ends():
    device = [(20, 30), (25, 40), (60, 70), (5, 8)]
    assert spans.idle_stretches((10, 100), device) == [(10, 20), (40, 60), (70, 100)]
    assert spans.idle_stretches((10, 100), []) == [(10, 100)]
    assert spans.idle_stretches((10, 100), [(0, 200)]) == []


@pytest.mark.parametrize("shift", [0, 1_000_000_007])
def test_parts_add_up_to_the_device_idle_share(shift):
    """Every idle nanosecond lands in one part, so the parts sum to the
    window's idle share as trace.py reads it (1 - busy / wall)."""
    to_ns = lambda t: t + shift  # noqa: E731
    window = (shift - 20, shift + 230)
    device = [(shift + 12, shift + 33), (shift + 44, shift + 80), (shift + 85, shift + 86),
              (shift + 95, shift + 140), (shift + 150, shift + 185)]
    busy = sum(e - s for s, e in device)  # apart, so the union is the sum
    wall = window[1] - window[0]
    idle = spans.idle_stretches(window, device)
    parts = spans.idle_parts(spans.idle_by_span(idle, RECORDS, to_ns), wall / 1e9)
    assert sum(parts.values()) == pytest.approx(100.0 * (1 - busy / wall), abs=1e-9)
    assert parts["outside"] > 0 and parts["env"] > 0 and parts["launch"] > 0
    assert set(parts) == {"env", "launch", "sync", "root", "outside"}


def test_categories():
    assert [spans.category(n) for n in ("teacher_episode", "rollout_inputs", "decode",
                                        "forward", "backward", "optimizer", "rollout",
                                        "sync", "outside", "train_iteration")] == [
        "env", "env", "env", "launch", "launch", "launch", "launch", "sync", "outside",
        "root"]


def test_window_stats_per_unit():
    got = spans.window_stats(RECORDS, COUNTERS, "train_iteration", 0, 300)
    assert got["units"] == 2
    # host work: 100 - 10 and 80 - 10
    assert got["host_work_ms"] == pytest.approx((90 + 70) / 2 / 1e6)
    assert got["spans"]["forward"]["count"] == pytest.approx(1.0)
    assert got["spans"]["forward"]["total_ms"] == pytest.approx((30 + 60) / 2 / 1e6)
    assert got["spans"]["forward"]["self_ms"] == pytest.approx((30 + 50) / 2 / 1e6)
    assert got["spans"]["train_iteration"]["self_ms"] == pytest.approx((20 + 20) / 2 / 1e6)
    assert got["counters"] == {"syncs": 1.0, "h2d_bytes": 32.0}
    second = spans.window_stats(RECORDS, COUNTERS, "train_iteration", 110, 300)
    assert second["units"] == 1 and second["counters"] == {"syncs": 1.0}
    assert spans.window_stats(RECORDS, COUNTERS, "eval_split_device", 0, 300)["units"] == 0


def test_the_probe_reads_the_span_metrics():
    from benchmark import span_probe

    idle = spans.idle_stretches((0, 250), [(5, 15), (42, 80), (100, 185)])
    by_span = spans.idle_by_span(idle, RECORDS)
    p = {"idle_parts": spans.idle_parts(by_span, 250 / 1e9),
         "untraced": spans.window_stats(RECORDS, COUNTERS, "train_iteration", 0, 300)}
    got = span_probe.metrics("train", p)
    assert got["syncs_per_update.train"] == 1.0
    assert got["allocator_calls_per_update.train"] is None  # a CPU run counts none
    assert got["host_work_ms_per_update.train"] == pytest.approx(80 / 1e6)
    # idle 15-42: 15-30 under the teacher episode, 30-40 its copy's wait
    assert got["idle_env.train"] == pytest.approx(100 * 15 / 250)
    assert set(span_probe.metrics("eval", p)) == {"idle_env.eval", "idle_launch.eval"}
