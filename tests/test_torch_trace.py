"""The port's spans and counters (aquery2_tpu_torch/runtime/stats.py): the
``aq.<name>`` profiler ranges at the layer boundaries of the group-by
tiers and the general join, ``tier_runs`` and ``syncs_by_site``, over
db-benchmark's G1 and J1 tables at 10,000 rows on the CPU."""

from __future__ import annotations

import pytest
import torch

import aquery2_tpu_torch
import chip_smoke
from aquery2_tpu_torch import types as T
from aquery2_tpu_torch.ops import kernels as K
from aquery2_tpu_torch.repl.prompt import Repl
from aquery2_tpu_torch.runtime import stats
from aquery2_tpu_torch.storage.table import Table
from aquery2_tpu_torch.utils.datagen import h2o_dim, h2o_g1, h2o_j1

N = 10_000
SEED = 19

DENSE = "SELECT id1, sum(v1) AS v1 FROM source GROUP BY id1"
INNER = ("SELECT x.id1, x.v1, medium.id4 AS medium_id4, v2 "
         "FROM x JOIN medium USING (id2)")
LEFT = ("SELECT x.id1, x.v1, medium.id4 AS medium_id4, v2 "
        "FROM x LEFT JOIN medium USING (id2)")
JOIN_PARTS = ("hash", "sort", "probe", "expand", "verify", "compose")


@pytest.fixture(scope="module")
def db():
    s = aquery2_tpu_torch.connect(device="cpu")
    s.catalog.create(Table.from_numpy("source", h2o_g1(N, 10, SEED),
                                      device="cpu"))
    s.catalog.create(Table.from_numpy("dim", h2o_dim(N, 10, SEED),
                                      device="cpu"))
    for name, (arrays, dicts) in h2o_j1(N, SEED).items():
        s.catalog.create(Table.from_numpy(
            name, arrays, {c: T.StrT for c in dicts}, device="cpu",
            dictionaries=dicts))
    return s


def traced(db, sql: str):
    """The program's spans of one execute of sql: (name without "aq.",
    start ns, end ns, thread), in start order."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        db.execute(sql)
    return sorted(((e.name()[3:], e.start_ns(), e.start_ns()
                    + e.duration_ns(), e.start_thread_id())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith("aq.")), key=lambda s: s[1])


def inside(inner, outer) -> bool:
    return (inner[3] == outer[3] and outer[1] <= inner[1]
            and inner[2] <= outer[2])


def test_span_without_a_profiler_is_the_shared_null_context():
    assert not torch.autograd.profiler._is_profiler_enabled
    a, b = stats.span("plan"), stats.span("join.hash")
    assert a is b is stats.sync("join.candidates")
    with a:
        pass


def test_spans_leave_no_range_on_the_device_timeline(db):
    """kineto copies a user annotation (``record_function``'s ranges) onto
    the device's timeline, spanning the kernels launched inside it, and a
    reader of the trace would count that as device work; the program's
    spans are not user annotations."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("user"):
            db.execute(DENSE)
    evs = {e.name(): e for e in prof.profiler.kineto_results.events()}
    assert evs["user"].is_user_annotation()
    assert not any(e.is_user_annotation()
                   for n, e in evs.items() if n.startswith("aq."))


def test_dense_group_by_spans_lie_inside_execute(db):
    spans = traced(db, DENSE)
    names = [s[0] for s in spans]
    for want in ("plan", "groupby.dense", "finish",
                 "sync.groupby.dense.present"):
        assert want in names, names
    (execute,) = [s for s in spans if s[0] == "execute"]
    assert all(inside(s, execute) for s in spans if s is not execute)
    (dense,) = [s for s in spans if s[0] == "groupby.dense"]
    (present,) = [s for s in spans
                  if s[0] == "sync.groupby.dense.present"]
    assert inside(present, dense)


@pytest.mark.parametrize("sql, outer", [(INNER, False), (LEFT, True)])
def test_join_parts_each_once(db, sql, outer):
    spans = traced(db, sql)
    names = [s[0] for s in spans]
    for part in JOIN_PARTS:
        assert names.count(f"join.{part}") == 1, names
    assert names.count("join.outer") == int(outer)
    (execute,) = [s for s in spans if s[0] == "execute"]
    assert all(inside(s, execute) for s in spans if s is not execute)


@pytest.mark.parametrize("sql, sites", [
    (INNER, {"join.candidates": 1, "join.verified": 1}),
    (LEFT, {"join.candidates": 1, "join.verified": 1,
            "join.unmatched_left": 1}),
    ("SELECT x.id1, medium.id2 AS m2 FROM x JOIN medium USING (id5)",
     {"strings.translate": 1, "join.candidates": 1, "join.verified": 1}),
])
def test_syncs_by_site_of_a_join(db, sql, sites):
    db.stats.reset()
    for _ in range(3):
        db.execute(sql)
    assert db.stats.syncs_by_site == {k: 3 * v for k, v in sites.items()}


@pytest.mark.parametrize("sql, tier", [
    (DENSE, "dense"),
    ("SELECT id3, sum(v1) AS v1 FROM source GROUP BY id3", "packed"),
    ("SELECT id3, sum(v1) AS v1 FROM source GROUP BY id3 % 7, id3",
     "sort"),
    ("SELECT id6, subvec(v3, 0, 2) AS largest2_v3 FROM source "
     "ASSUMING DESC v3 GROUP BY id6", "ordered"),
    ("SELECT id1, v1 FROM source WHERE v1 > 3", "scan"),
    (INNER, "general"),
])
def test_tier_runs_name_the_tier(db, sql, tier):
    db.stats.reset()
    db.execute(sql)
    assert db.stats.tier_runs == {tier: 1}


@pytest.mark.parametrize("q, tiers, tier", [
    ("qjg", ["dense", "star join"], "star"),
    ("qj", ["count join"], "count_join"),
    ("q1", ["dense"], "dense"),
    ("q3", ["packed"], "packed"),
])
def test_plan_probe_sees_each_tier_once_counted(db, q, tiers, tier):
    """chip_smoke.PlanProbe sees every tier that ran, the star join's
    inner group-by too, innermost first; ``tier_runs`` counts the SELECT
    once, under the tier that answered it."""
    db.stats.reset()
    with chip_smoke.PlanProbe() as plan:
        db.execute(chip_smoke.QUERIES[q])
    assert plan.tiers == tiers
    assert db.stats.tier_runs == {tier: 1}


def test_repl_stats_prints_and_resets_the_counters(db, capsys):
    r = Repl(db)
    r.handle_line("stats reset")
    for _ in range(12):
        db.execute(LEFT)
    st = db.stats
    assert st.queries == 12 and len(st.history) == stats.HISTORY == 10
    capsys.readouterr()
    r.handle_line("stats")
    out = capsys.readouterr().out
    assert "Tiers:            general=12" in out
    assert ("Host syncs:       join.candidates=12, join.unmatched_left=12, "
            "join.verified=12") in out
    assert out.count("FROM x LEFT JOIN medium") == 10
    r.handle_line("stats reset")
    assert not st.tier_runs and not st.syncs_by_site and not st.history
    r.handle_line("stats off")
    db.execute(DENSE)
    assert not st.tier_runs and not st.syncs_by_site
    r.handle_line("stats on")


def test_repl_stats_prints_kernel_launches_and_onehot_lanes(db, capsys,
                                                           monkeypatch):
    """`stats` prints the process's kernel launches and the onehot lanes
    they summed by dtype, when any launched (CPU tensors launch none), the
    onehot_segment_sums calls by form, when any was made, and the radix
    sorts' packs by route with their digit passes, when any was sorted on
    the card; `stats reset` clears them with the session's counters."""
    r = Repl(db)
    capsys.readouterr()
    r.handle_line("stats")
    assert "Kernel launches" not in capsys.readouterr().out
    monkeypatch.setattr(K, "LAUNCHES", {"seg_cumsum_i64": 0,
                                        "onehot_segment_sums": 3,
                                        "radix_sort_pairs": 4})
    monkeypatch.setattr(K, "ONEHOT_LANES", {"int64": 0, "int32": 4,
                                            "bool": 3, "float64": 1,
                                            "product": 0, "count": 2})
    monkeypatch.setattr(K, "ONEHOT_FORMS", {"keyed": 2, "code": 1})
    monkeypatch.setattr(K, "SORT_PACKS", {"u32": 3, "u64": 0, "f64": 1,
                                          "passes": 20})
    r.handle_line("stats")
    out = capsys.readouterr().out
    assert ("Kernel launches:  onehot_segment_sums=3, radix_sort_pairs=4\n"
            in out)
    assert "Onehot lanes:     int32=4, bool=3, float64=1, count=2\n" in out
    assert "Onehot forms:     keyed=2, code=1\n" in out
    assert "Sort packs:       u32=3, f64=1, passes=20\n" in out
    r.handle_line("stats reset")
    r.handle_line("stats")
    out = capsys.readouterr().out
    assert "Kernel launches" not in out and "Onehot lanes" not in out
    assert "Onehot forms" not in out and "Sort packs" not in out
    assert not any(K.LAUNCHES.values()) and not any(K.ONEHOT_LANES.values())
    assert not any(K.ONEHOT_FORMS.values())
    assert not any(K.SORT_PACKS.values())
