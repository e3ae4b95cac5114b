"""The metric arithmetic on the CPU, from synthetic events: the union
of device intervals and the idle share, each hand kernel's bytes and
bound at PERF.md section 6's shapes, the window's rate and 95th
percentile over all queries, and each reader."""

from __future__ import annotations

import pytest
import torch
from qbench_cells import run_small
from qbench import harness, roofline, trace

H100 = roofline.HBM_BYTES_PER_S["NVIDIA H100 80GB HBM3"]


def test_union_and_idle_share():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert trace.union(iv) == [(0.0, 2.0), (3.0, 4.0)]
    busy = sum(e - s for s, e in trace.union(iv))
    assert busy == 3.0
    w = trace.Window(window_s=5.0, busy_s=busy,
                     device=[("k", 0.0, 1.0)])
    idle = harness.load_module("metrics", "device.idle_share").read(w)
    assert idle == pytest.approx(40.0)
    assert trace.gaps(trace.union(iv), 0.0, 5.0) == [(2.0, 3.0), (4.0, 5.0)]


def test_idle_gaps_are_named_by_spans():
    spans = [("q1.parse", 0.0, 1.0), ("q1.execute", 1.0, 3.0),
             ("q1.sync", 3.0, 4.0)]
    got = trace.overlap_by_label(spans, [(0.5, 1.5), (3.5, 5.0)])
    assert got == {"q1.parse": 0.5, "q1.execute": 0.5, "q1.sync": 0.5,
                   "harness": 1.0}


@pytest.mark.parametrize("rows", [12_582_912, 100_663_296])
def test_hand_kernel_bytes_per_row(rows):
    """PERF.md section 6's B/row: seg_cumsum_i64 17; seg_scan_multi
    3 x 32-bit 25, q7's 2 x int32 17, 3 x 64-bit 49; onehot q1 9 and
    q9 37 (plus the [dp, k] sums); fused_running_stats 16. Meta tensors:
    no memory is taken."""
    def meta(dtype):
        return torch.empty(rows, dtype=dtype, device="meta")
    f = meta(torch.bool)
    assert roofline.call_bytes("seg_cumsum_i64",
                               (f, meta(torch.int64))) == 17 * rows
    for lanes, dtype, per in ((3, torch.float32, 25), (2, torch.int32, 17),
                              (3, torch.int64, 49)):
        xs = tuple(meta(dtype) for _ in range(lanes))
        assert roofline.call_bytes("seg_scan_multi",
                                   (f, xs, ("add",) * lanes)) == per * rows
    code = meta(torch.int32)
    q1 = (meta(torch.bool), meta(torch.int32))
    assert roofline.call_bytes("onehot_segment_sums", (code, q1, 11)) == \
        9 * rows + 8 * 11 * 2
    q9 = (meta(torch.bool), meta(torch.int32), meta(torch.int32),
          meta(torch.int64), meta(torch.int64), meta(torch.int64))
    assert roofline.call_bytes("onehot_segment_sums", (code, q9, 101)) == \
        37 * rows + 8 * 101 * 6
    assert roofline.call_bytes("fused_running_stats",
                               (meta(torch.float32),)) == 16 * rows
    # PERF.md section 6: q3's seg_cumsum_i64 at 1e8, bound 0.5108 ms
    if rows == 100_663_296:
        assert roofline.bound_s(17 * rows, H100) * 1e3 == \
            pytest.approx(0.5108, abs=1e-4)


def test_roofline_share_reads_bytes_over_kernel_time():
    w = trace.Window(kernel_calls=[("seg_cumsum_i64", 1_000_000_000)],
                     device=[("void segscan_lookback<x>(...)", 0.0, 0.001),
                             ("void onehot_sums<2, true>(Params)", 0.001,
                              0.0015),
                             ("other", 0.0, 1.0)],
                     hbm_bytes_per_s=H100, queries=2)
    share = harness.load_module("metrics", "kernels.roofline_share").read(w)
    assert share == pytest.approx(100 * (1e9 / H100) / 0.0015)
    w.hbm_bytes_per_s = None                     # a card of no known peak
    assert harness.load_module("metrics",
                               "kernels.roofline_share").read(w) is None
    assert harness.load_module("metrics",
                               "ops.sort_ms_per_query").read(w) is None
    w.device.append(("DeviceRadixSortOnesweepKernel", 2.0, 2.004))
    assert harness.load_module("metrics", "ops.sort_ms_per_query").read(
        w) == pytest.approx(2.0)


def test_rate_and_tail_are_over_all_queries():
    """Ten mixes of a cheap query and one costly one: the rate counts
    every completed query's rows over the whole window, and the tail is
    the percentile of all latencies, not of a per-query median."""
    lat = [0.001, 0.1] * 10 + [0.002] * 80
    loop = harness.Loop(lat, [], 100, 100 * 10**8, 4.0, 10, {})
    m = harness.end_to_end(loop, 3 * 2**30, 7.5)
    assert m["rows_per_s"] == pytest.approx(2.5e9)
    assert m["query_p50_ms"] == pytest.approx(2.0)
    assert m["query_p95_ms"] == pytest.approx(100.0)
    assert m["peak_mem_gib"] == 3.0 and m["setup_s"] == 7.5
    assert harness.percentile(list(range(101)), 95) == 95.0


def test_untraced_run_reports_the_cells_end_to_end_metrics():
    out = run_small("h2o_g1_1e8.dense", seconds=0.3)
    c = harness.find_cell("h2o_g1_1e8.dense")
    assert out["correct"] and out["failed"] == 0
    assert sorted(out["metrics"]) == sorted(m["name"] for m in c.end_to_end)
    cycles, rest = divmod(out["attempted"], len(c.queries))
    assert rest == 0 and cycles >= harness.MIN_CYCLES      # whole mixes
    assert list(out)[-1] == "checks"


def test_traced_run_reports_layer_metrics_and_breakdown():
    out = run_small("h2o_j1_1e7.join", traced=True)
    assert out["correct"]
    assert "frontend.parse_ms" in out["metrics"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert out["device"]["window_s"] > 0
