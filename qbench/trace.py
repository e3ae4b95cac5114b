"""The traced window: the profiler's device events, the benchmark's own
spans, and what the per-layer metrics read from them.

Spans are ``torch.profiler.record_function`` ranges opened by the
harness around its calls into the program: ``qbench.<query>`` around one
query, ``qbench.<query>.parse``, ``.execute`` and ``.sync`` inside it,
and ``qbench.sample_copy`` around the harness's copy of a sampled answer
to the host, which is not the program's work: the window's clock stops
for it, and its device events and its time are left out here too.

Device time is the union of the intervals of the device's events
(kernels, copies, memsets), as ``profile_queries.py``'s ``busy_us``
computes it. Imports torch only: nothing of the program.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

PREFIX = "qbench."
PAUSE = PREFIX + "sample_copy"
LEAVES = (".parse", ".execute", ".sync")


def union(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals, as sorted disjoint ones."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def gaps(busy_iv, start: float, end: float) -> list[tuple[float, float]]:
    """The stretches of [start, end] that no interval of the sorted,
    disjoint busy_iv covers."""
    out, at = [], start
    for s, e in busy_iv:
        if s > at:
            out.append((at, min(s, end)))
        at = max(at, e)
        if at >= end:
            break
    if at < end:
        out.append((at, end))
    return [(s, e) for s, e in out if e > s]


def overlap_by_label(spans, stretches) -> dict[str, float]:
    """Seconds of the sorted, disjoint stretches that fall inside each
    labelled span of the sorted, disjoint spans (label, start, end); the
    rest under "harness"."""
    out: dict[str, float] = defaultdict(float)
    j = 0
    for s, e in stretches:
        covered = 0.0
        while j < len(spans) and spans[j][2] <= s:
            j += 1
        k = j
        while k < len(spans) and spans[k][1] < e:
            lo, hi = max(s, spans[k][1]), min(e, spans[k][2])
            if hi > lo:
                out[spans[k][0]] += hi - lo
                covered += hi - lo
            k += 1
        if e - s > covered:
            out["harness"] += e - s - covered
    return dict(out)


@dataclass
class Window:
    """What one traced window gives the per-layer metrics' readers.

    queries: queries completed in the window. parse_s: the program's own
    parse time over them (``Session.stats.parse_time``). syncs: host
    syncs torch's sync debug mode reported inside the program's calls.
    kernel_calls: (entry point, bytes) of each hand-kernel call the
    program made. device: (name, start_s, end_s) of each device event.
    window_s: the window's length without the harness's pauses. busy_s:
    device time in it. hbm_bytes_per_s: the card's peak rate (None for a
    card the peaks' table lacks)."""
    queries: int = 0
    parse_s: float = 0.0
    syncs: int = 0
    kernel_calls: list[tuple[str, int]] = field(default_factory=list)
    device: list[tuple[str, float, float]] = field(default_factory=list)
    window_s: float = 0.0
    busy_s: float = 0.0
    hbm_bytes_per_s: float | None = None
    idle_by_span: dict[str, float] = field(default_factory=dict)

    def device_seconds(self, match) -> tuple[float, int]:
        """(seconds, events) of the device events whose name match(name)
        accepts."""
        hits = [e - s for name, s, e in self.device if match(name)]
        return sum(hits), len(hits)

    def breakdown(self, top: int = 10) -> dict:
        by_name: dict[str, float] = defaultdict(float)
        for name, s, e in self.device:
            by_name[name[:160]] += e - s
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        idle = sorted(self.idle_by_span.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in idle]}


def read_profile(prof, window: Window) -> Window:
    """Fill window's device events, window_s, busy_s and idle_by_span
    from a finished torch.profiler run over the window."""
    spans, pauses, dev = [], [], []
    for ev in prof.profiler.kineto_results.events():
        s = ev.start_ns() * 1e-9
        e = s + ev.duration_ns() * 1e-9
        if str(ev.device_type()).endswith("CPU"):
            name = ev.name()
            if name == PAUSE:
                pauses.append((s, e))
            elif name.startswith(PREFIX):
                spans.append((name[len(PREFIX):], s, e))
        elif not ev.name().startswith(PREFIX):   # not a span's shadow
            dev.append((ev.name(), s, e))
    queries = [sp for sp in spans if not sp[0].endswith(LEAVES)]
    if not queries:
        return window
    start = min(s for _, s, _ in queries)
    end = max(e for _, _, e in queries)
    pauses = union(pauses)
    in_pause = lambda t: any(s <= t < e for s, e in pauses)  # noqa: E731
    window.device = [(n, s, e) for n, s, e in dev
                     if start <= s < end and not in_pause(s)]
    busy_iv = union([(max(s, start), min(e, end))
                     for _, s, e in window.device])
    window.busy_s = sum(e - s for s, e in busy_iv)
    window.window_s = (end - start) - sum(e - s for s, e in pauses)
    idle = gaps(union(busy_iv + pauses), start, end)
    leaves = sorted((sp for sp in spans if sp[0].endswith(LEAVES)),
                    key=lambda sp: sp[1])
    window.idle_by_span = overlap_by_label(leaves, idle)
    return window
