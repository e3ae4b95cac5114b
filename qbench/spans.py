"""The program's own spans in a traced window, for the per-layer metrics
that read them.

The program (``aquery2_tpu_torch/runtime/stats.py``) opens ``aq.<name>``
ranges while torch's profiler records: ``aq.execute`` around each
statement, ``aq.plan``, ``aq.groupby.<tier>``, ``aq.finish``,
``aq.join.<part>``, ``aq.sync.<site>`` and others inside it. They are
CPU ranges with no shadow on the device's timeline, so the harness's
reading of the device (``trace.read_profile``) sees none of them.

``trace.Window`` holds the device events but not the CPU ranges, so
``from_caller`` takes them from the finished profile of the harness's
run, found in the calling frames. A device event belongs to a span when the
host call that launched it (a CUDA runtime event, ``cudaLaunchKernel``,
``cudaMemcpyAsync``, ..., linked to it by its correlation id) started
inside the span, on the span's thread. ``idle_by_program_span`` names
the idle inside each harness ``<query>.execute`` span by the program's
innermost span there (``qbench/idle_by_span.py`` prints it for one
traced window). Imports torch only.
"""

from __future__ import annotations

import bisect
import math
import sys
import weakref
from collections import Counter, defaultdict
from dataclasses import dataclass, field

import torch

from qbench import trace

PREFIX = "aq."
SYNC = "sync."


@dataclass
class ProgramSpans:
    """spans: (name without "aq.", start_s, end_s, thread) of each span.
    launched: (host launch time s, thread, device start s, device end s)
    of each device event whose launch the trace links to it. device: the
    trace has device events at all."""
    spans: list[tuple[str, float, float, int]] = field(default_factory=list)
    launched: list[tuple[float, int, float, float]] = field(
        default_factory=list)
    device: bool = False

    def intervals(self, match) -> dict[int, list[tuple[float, float]]]:
        """The union of the spans whose name match(name) accepts, by
        thread."""
        by_thread: dict[int, list] = {}
        for name, s, e, tid in self.spans:
            if match(name):
                by_thread.setdefault(tid, []).append((s, e))
        return {t: trace.union(iv) for t, iv in by_thread.items()}

    def device_seconds(self, match) -> float | None:
        """Seconds of the union of the device events launched inside the
        spans match accepts; None where no such span ran or the trace has
        no device."""
        spans = self.intervals(match)
        if not spans or not self.device:
            return None
        hits = [(ds, de) for t, tid, ds, de in self.launched
                if _inside(t, spans.get(tid, ()))]
        return sum(e - s for s, e in trace.union(hits))

    def host_self_seconds(self, match) -> float | None:
        """Host seconds inside the spans match accepts, less the parts the
        ``sync.`` spans cover; None where no such span ran."""
        spans = self.intervals(match)
        if not spans:
            return None
        syncs = self.intervals(lambda n: n.startswith(SYNC))
        return sum(sum(e - s for s, e in iv)
                   - _overlap(iv, syncs.get(tid, []))
                   for tid, iv in spans.items())


def _inside(t: float, iv) -> bool:
    """t lies in one of the sorted, disjoint intervals iv."""
    i = bisect.bisect_right(iv, (t, math.inf)) - 1
    return i >= 0 and t < iv[i][1]


def _overlap(a, b) -> float:
    """Seconds that the sorted, disjoint intervals a and b share."""
    out, j = 0.0, 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            out += max(0.0, min(e, b[k][1]) - max(s, b[k][0]))
            k += 1
    return out


def read_events(events) -> ProgramSpans:
    """ProgramSpans of a profile's events (kineto's: name(),
    device_type(), start_ns(), duration_ns(), correlation_id(),
    start_thread_id(), is_user_annotation())."""
    out = ProgramSpans()
    launches: dict[int, tuple[float, int]] = {}
    on_device: dict[int, list[tuple[float, float]]] = {}
    for ev in events:
        name = ev.name()
        s = ev.start_ns() * 1e-9
        e = s + ev.duration_ns() * 1e-9
        if str(ev.device_type()).endswith("CPU"):
            if name.startswith(PREFIX):
                out.spans.append((name[len(PREFIX):], s, e,
                                  ev.start_thread_id()))
            elif name.startswith("cu"):     # a CUDA API call (cuda*, cu*)
                launches[ev.correlation_id()] = (s, ev.start_thread_id())
        elif not (ev.is_user_annotation()
                  or name.startswith(trace.PREFIX)):
            out.device = True
            on_device.setdefault(ev.correlation_id(), []).append((s, e))
    for corr, ivs in on_device.items():
        if corr in launches:
            t, tid = launches[corr]
            out.launched += [(t, tid, s, e) for s, e in ivs]
    return out


def innermost(spans) -> list[tuple[str, float, float]]:
    """The sorted, disjoint segments (name, start, end) of nested spans
    (name, start, end) of one thread: at each instant, the innermost span
    that covers it."""
    out: list[tuple[str, float, float]] = []
    stack: list[tuple[str, float, float]] = []
    at = 0.0

    def close(upto: float) -> None:
        nonlocal at
        while stack and stack[-1][2] <= upto:
            name, _, e = stack.pop()
            if e > at:
                out.append((name, at, e))
            at = e

    for name, s, e in sorted(spans, key=lambda sp: (sp[1], -sp[2])):
        close(s)
        if stack and s > at:
            out.append((stack[-1][0], at, s))
        stack.append((name, s, e))
        at = s
    close(math.inf)
    return out


def _idle_and_leaves(events):
    """The window's idle stretches and the harness's leaf spans (label,
    start, end), as trace.read_profile finds them."""
    spans, pauses, dev = [], [], []
    for ev in events:
        s = ev.start_ns() * 1e-9
        e = s + ev.duration_ns() * 1e-9
        name = ev.name()
        if str(ev.device_type()).endswith("CPU"):
            if name == trace.PAUSE:
                pauses.append((s, e))
            elif name.startswith(trace.PREFIX):
                spans.append((name[len(trace.PREFIX):], s, e))
        elif not name.startswith(trace.PREFIX):
            dev.append((s, e))
    queries = [sp for sp in spans if not sp[0].endswith(trace.LEAVES)]
    if not queries:
        return [], []
    start = min(s for _, s, _ in queries)
    end = max(e for _, _, e in queries)
    pauses = trace.union(pauses)
    busy = trace.union([(max(s, start), min(e, end)) for s, e in dev
                        if start <= s < end
                        and not any(a <= s < b for a, b in pauses)])
    leaves = sorted((sp for sp in spans if sp[0].endswith(trace.LEAVES)),
                    key=lambda sp: sp[1])
    return trace.gaps(trace.union(busy + pauses), start, end), leaves


def _pieces(spans, stretches) -> list[tuple[str, float, float]]:
    """(label, start, end) of each part of the sorted, disjoint stretches
    that lies inside a span of the sorted, disjoint spans (label, start,
    end)."""
    out, j = [], 0
    for s, e in stretches:
        while j < len(spans) and spans[j][2] <= s:
            j += 1
        k = j
        while k < len(spans) and spans[k][1] < e:
            lo, hi = max(s, spans[k][1]), min(e, spans[k][2])
            if hi > lo:
                out.append((spans[k][0], lo, hi))
            k += 1
    return out


def idle_by_program_span(events) -> dict[str, float]:
    """The idle seconds of a traced window by label: trace.read_profile's
    labels (the breakdown's ``idle_gaps``), with the idle inside each
    ``<query>.execute`` split by the innermost program span below
    ``aq.execute`` that covers it, as ``<query>.execute/<span without
    "aq.">``; idle that no such span covers keeps ``<query>.execute``, so
    each query's total is trace.read_profile's. The program's spans are
    those of the thread that ran the statements."""
    idle, leaves = _idle_and_leaves(events)
    prog = read_events(events).spans
    tids = Counter(t for n, _, _, t in prog if n == "execute")
    tid = tids.most_common(1)[0][0] if tids else None
    segs = innermost([(n, s, e) for n, s, e, t in prog
                      if t == tid and n != "execute"])
    ends = [e for _, _, e in segs]
    out = defaultdict(float, trace.overlap_by_label(leaves, idle))
    execs = [sp for sp in leaves if sp[0].endswith(".execute")]
    for q, s, e in _pieces(execs, idle):
        i = bisect.bisect_right(ends, s)
        while i < len(segs) and segs[i][1] < e:
            name, a, b = segs[i]
            part = min(e, b) - max(s, a)
            if part > 0:
                out[f"{q}/{name}"] += part
                out[q] -= part
            i += 1
    return dict(out)


_last: tuple[weakref.ref, ProgramSpans] | None = None


def from_caller() -> ProgramSpans | None:
    """The program's spans of the traced window whose readers are being
    called: read from the profile that the calling frames hold (the
    harness's run), once per profile; None where no caller holds one."""
    global _last
    frame = sys._getframe(1)
    while frame is not None:
        prof = next((v for v in frame.f_locals.values()
                     if isinstance(v, torch.profiler.profile)), None)
        if prof is not None:
            break
        frame = frame.f_back
    if prof is None:
        return None
    if _last is None or _last[0]() is not prof:
        _last = (weakref.ref(prof),
                 read_events(prof.profiler.kineto_results.events()))
    return _last[1]


def per_query_ms(window: trace.Window, seconds) -> float | None:
    """seconds (a function of the window's ProgramSpans, or None) in ms
    per query completed in the window; None where it gives None."""
    got = from_caller()
    v = None if got is None or not window.queries else seconds(got)
    return None if v is None else v * 1e3 / window.queries
