"""qbench/spans.py, the three metrics that read the program's spans and
qbench/idle_by_span.py, from synthetic profile events, and from traced
runs of the cells at their small size on the CPU."""

from __future__ import annotations

import time
from types import SimpleNamespace

import pytest
import torch
from qbench_cells import SEED, run_small, small_cell
from qbench import harness, idle_by_span, spans, trace

MS = 1_000_000                          # ns


class Ev:
    """A kineto event's face, as spans.read_events reads it."""

    def __init__(self, name, start_ms, dur_ms, device="CPU", corr=0,
                 tid=1, annotation=False):
        self._v = (name, device, int(start_ms * MS), int(dur_ms * MS), corr,
                   tid, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return f"DeviceType.{self._v[1]}"

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def start_thread_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[6]


def launch(corr, at_ms, dev_start_ms, dev_ms, kernel="k"):
    return [Ev("cudaLaunchKernel", at_ms, 0.01, corr=corr),
            Ev(kernel, dev_start_ms, dev_ms, device="CUDA", corr=corr)]


# two queries: a dense group-by (its plan with a nested sync, the tier
# launching two kernels that overlap on the device) and a join (its
# hash and probe launching one kernel each, and one launched outside any
# join span), plus a harness span's device shadow
EVENTS = [
    Ev("aq.execute", 0, 10), Ev("aq.plan", 1, 2),
    Ev("aq.sync.groupby.float_fit", 2, 0.5),
    Ev("aq.groupby.dense", 3, 4),
    *launch(101, 3.5, 4, 3), *launch(102, 4, 6, 2),
    Ev("aq.execute", 20, 10), Ev("aq.plan", 20.5, 0.5),
    Ev("aq.join.hash", 21, 1), *launch(103, 21.5, 22, 1),
    Ev("aq.join.probe", 23, 1), *launch(104, 23.5, 24, 0.5),
    *launch(105, 26, 26, 2),
    Ev("qbench.q1", 0, 30, device="CUDA", corr=1, annotation=True),
]


def test_read_events_links_launches_to_device_events():
    p = spans.read_events(EVENTS)
    assert p.device
    assert len(p.spans) == 8 and len(p.launched) == 5
    assert (p.device_seconds(lambda n: n == "groupby.dense")
            == pytest.approx(4e-3))     # [4, 7] and [6, 8]
    assert (p.device_seconds(lambda n: n.startswith("join."))
            == pytest.approx(1.5e-3))
    assert p.device_seconds(lambda n: n == "groupby.packed") is None
    # 2 ms of plan less its 0.5 ms sync, and 0.5 ms
    assert (p.host_self_seconds(lambda n: n == "plan")
            == pytest.approx(2.0e-3))


def test_device_readers_give_none_without_device_events():
    p = spans.read_events([e for e in EVENTS
                           if e.device_type().endswith("CPU")])
    assert not p.device
    assert p.device_seconds(lambda n: n == "groupby.dense") is None
    assert p.host_self_seconds(lambda n: n == "plan") is not None


def test_a_launch_on_another_thread_is_not_the_spans():
    evs = [Ev("aq.join.hash", 0, 2, tid=1),
           Ev("cudaLaunchKernel", 1, 0.01, corr=7, tid=2),
           Ev("k", 1, 1, device="CUDA", corr=7)]
    p = spans.read_events(evs)
    assert p.device_seconds(lambda n: n.startswith("join.")) == 0


@pytest.mark.parametrize("metric, value", [
    ("engine.dense_tier_ms_per_query", 2.0),
    ("ops.join_ms_per_query", 0.75),
    ("engine.plan_ms_per_query", 1.0),
])
def test_each_reader_gives_its_value_and_none_without_its_span(
        monkeypatch, metric, value):
    read = harness.load_module("metrics", metric).read
    w = trace.Window(queries=2)
    monkeypatch.setattr(spans, "from_caller",
                        lambda: spans.read_events(EVENTS))
    assert read(w) == pytest.approx(value)
    monkeypatch.setattr(spans, "from_caller",
                        lambda: spans.read_events(EVENTS[-1:]))
    assert read(w) is None
    monkeypatch.setattr(spans, "from_caller", lambda: None)
    assert read(w) is None


def test_from_caller_finds_the_profile_of_a_calling_frame():
    assert spans.from_caller() is None
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch._C._profiler._RecordFunctionFast("aq.plan"):
            pass
    got = spans.from_caller()
    assert [s[0] for s in got.spans] == ["plan"]
    assert spans.from_caller() is got    # read once a profile
    del prof


def test_traced_small_dense_run_reports_the_plan_time():
    out = run_small("h2o_g1_1e8.dense", traced=True)
    assert out["correct"]
    assert out["metrics"]["engine.plan_ms_per_query"]["value"] > 0
    # a CPU run has no device: the device readers give nothing
    assert "engine.dense_tier_ms_per_query" not in out["metrics"]


@pytest.mark.parametrize("cell, names", [
    ("h2o_g1_1e8.dense", {"plan", "groupby.dense"}),
    ("h2o_j1_1e7.join", {"plan", "join.hash", "join.probe"}),
])
def test_traced_harness_run_hands_each_reader_the_program_spans(
        monkeypatch, cell, names):
    """spans.from_caller finds the profile that harness.run holds: each
    reader of the program's spans that the cell lists (two a cell) is
    handed the window's spans, with those its metric reads (a CPU run has no device, so the device readers then
    give None; their reading of the device is tested above)."""
    found, real = [], spans.from_caller

    def spy():
        got = real()
        found.append(got)
        return got
    monkeypatch.setattr(spans, "from_caller", spy)
    out = run_small(cell, traced=True)
    assert out["correct"]
    assert len(found) == 2 and all(p is not None for p in found)
    assert names <= {s[0] for s in found[0].spans}
    assert found[0].host_self_seconds(lambda n: n == "plan") > 0


def test_innermost_gives_the_deepest_span_at_each_instant():
    got = spans.innermost([("a", 0, 10), ("b", 2, 8), ("c", 3, 4),
                           ("d", 9, 9.5), ("e", 10, 12)])
    assert got == [("a", 0, 2), ("b", 2, 3), ("c", 3, 4), ("b", 4, 8),
                   ("a", 8, 9), ("d", 9, 9.5), ("a", 9.5, 10),
                   ("e", 10, 12)]


def as_profile(events):
    """The face of a finished torch.profiler run that trace.read_profile
    reads."""
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


# two queries' harness spans over the program's (ms): q1's execute
# [0, 10] holds plan [1, 3] (a sync [2, 2.5] in it) and the tier [3, 7],
# whose one kernel runs [4, 6]; q2's execute [12, 20] holds a join hash
# [13, 14] and runs nothing on the device; a sample copy pauses the
# window
IDLE_EVENTS = [
    Ev("qbench.q1", 0, 11), Ev("qbench.q1.parse", 0, 0),
    Ev("qbench.q1.execute", 0, 10), Ev("qbench.q1.sync", 10, 1),
    Ev("aq.execute", 0, 10), Ev("aq.plan", 1, 2),
    Ev("aq.sync.groupby.float_fit", 2, 0.5), Ev("aq.groupby.dense", 3, 4),
    *launch(1, 3.5, 4, 2),
    Ev("qbench.sample_copy", 11, 1),
    Ev("qbench.q2", 12, 8), Ev("qbench.q2.execute", 12, 8),
    Ev("aq.execute", 12, 8), Ev("aq.join.hash", 13, 1),
    Ev("qbench.q1", 0, 11, device="CUDA", corr=9, annotation=True),
]


def test_idle_by_program_span_splits_each_execute_and_keeps_its_total():
    base = trace.read_profile(as_profile(IDLE_EVENTS),
                              trace.Window()).idle_by_span
    got = spans.idle_by_program_span(IDLE_EVENTS)
    assert got == pytest.approx({
        "q1.execute": 4e-3, "q1.execute/plan": 1.5e-3,
        "q1.execute/sync.groupby.float_fit": 0.5e-3,
        "q1.execute/groupby.dense": 2e-3, "q1.sync": 1e-3, "harness": 0,
        "q2.execute": 7e-3, "q2.execute/join.hash": 1e-3}, abs=1e-12)
    for label, secs in base.items():
        assert sum(v for k, v in got.items()
                   if k.split("/")[0] == label) == pytest.approx(secs)
    assert base["q1.execute"] == pytest.approx(8e-3)


def test_idle_by_program_span_without_program_spans_is_the_breakdown():
    evs = [e for e in IDLE_EVENTS if not e.name().startswith("aq.")]
    base = trace.read_profile(as_profile(evs), trace.Window()).idle_by_span
    assert spans.idle_by_program_span(evs) == pytest.approx(base)


def test_idle_by_span_summary_counts_shares_and_device_kinds():
    w = trace.Window(queries=2, device=[("k", 4.0, 6.0),
                                        ("Memcpy HtoD (Pageable -> Device)",
                                         6.0, 6.5),
                                        ("Memset (Device)", 7.0, 7.25)])
    got = idle_by_span.summary(IDLE_EVENTS, w)
    assert got["named_share"] == pytest.approx({"q1.execute": 0.5,
                                                "q2.execute": 1 / 8})
    assert got["execute_idle"] == pytest.approx({"q1.execute": 8e-3,
                                                 "q2.execute": 8e-3})
    assert got["device_per_query"] == {
        "copy": {"events": 0.5, "ms": 250.0},
        "kernel": {"events": 0.5, "ms": 1000.0},
        "memset": {"events": 0.5, "ms": 125.0}}


def test_idle_by_span_names_the_small_join_cells_execute_idle():
    """A traced small run of the join cell on the CPU (no device: the
    whole window is idle): each query's execute idle keeps the breakdown's
    total, and the join's spans name most of it."""
    got = idle_by_span.traced(small_cell("h2o_j1_1e7.join"), SEED, 0.2,
                              torch.device("cpu"), time.perf_counter(),
                              log=lambda msg: None)
    assert got["correct"] and got["queries"] > 0
    assert got["breakdown"]["idle_gaps"]
    for label, secs in got["breakdown"]["idle_gaps"]:
        if label.endswith(".execute"):
            assert got["execute_idle"][label] == pytest.approx(secs)
    assert set(got["named_share"]) == {f"j1_q{i}.execute"
                                       for i in range(1, 6)}
    assert all(v > 0.5 for v in got["named_share"].values())
    assert any(k.endswith("/join.probe") for k in got["idle"])
