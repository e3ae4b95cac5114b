"""Per-query phase timers, user-FUNCTION routes, tiers, host syncs by
site, and the program's spans.

Counterpart of ``aquery2_tpu/runtime/stats.py`` (the reference's
``QueryStats``, prompt.py:125-161): the parse and execution time of each
``Session.execute`` and which route each FUNCTION call took.

The timers read the host's clock when a phase returns, and add no
``torch.cuda.synchronize``: CUDA work is queued asynchronously (as JAX
dispatches it), so ``exec`` is the time the host took to run the
statement, which includes the device's work only where the statement
itself waited for it (a host sync). A caller that wants the device's
time synchronizes itself. The host syncs a query makes are counted
elsewhere, and a timer must not add to them.

UDF routes (``note_udf``), with the JAX package's names (it has a
fused UDF tier and reports ``fused`` where the port reports ``traced``):
  rewritten      an accumulation loop rewritten into aggregates
                 (engine/udf_rewrite.py), so every tier runs it;
  traced         the batched device body in the general pipeline
                 (engine/udf_device.try_run_aggregation_udf);
  interpreted    the host interpreter, once per group: bodies the device
                 path cannot run (engine/udf.run_aggregation_udf);
  scalar_device  a scalar FUNCTION inlined into the evaluator;
  scalar_host    a scalar FUNCTION run by the host interpreter.
``enabled`` (the REPL's ``stats on|off``) stops and restarts the
counting.

Mesh sessions (parallel/mesh.py) count each SELECT, as the JAX package
does: ``dist_spmd`` when a distributed tier ran it over the ranks' blocks,
``dist_fallback`` when it ran the single-device engine over gathered
tables, with the first reason a tier gave for declining in
``dist_fallback_reasons``.

Two counters, also while ``enabled``: ``tier_runs``, the tier that
answered each SELECT (dense, packed, sort, ordered, star, count_join,
scan, general), and ``syncs_by_site``, each host read of a
device value by a stable site name (``join.candidates``,
``groupby.dense.present``, ...). Code below the executor takes no
session: ``Session`` makes its stats current (``counting``) while its
statements run, and ``note_tier`` and ``sync`` count into them.

Spans (``span``): ``aq.<name>`` ranges on torch.profiler's clock, made
only while a profiler records; otherwise ``span`` returns one shared null
context. They are ``_RecordFunctionFast`` ranges, not
``record_function``'s: the same CPU range at about a sixth of the cost,
and no shadow range on the device's timeline, which a reader of the
trace would count as device work. A span's parent is the range around it on its
thread; each statement's lie inside its ``aq.execute``.
"""

from __future__ import annotations

import contextlib
import time
from collections import deque
from contextlib import contextmanager
from contextvars import ContextVar
from dataclasses import dataclass, field

import torch

HISTORY = 10                # statements that ``format`` lists
_NULL = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled
_Range = torch._C._profiler._RecordFunctionFast


def span(name: str):
    """A profiler range ``aq.<name>`` while torch's profiler records, else
    the shared null context."""
    return _Range("aq." + name) if _recording() else _NULL


@dataclass
class QueryStats:
    enabled: bool = True
    parse_time: float = 0.0
    exec_time: float = 0.0
    queries: int = 0
    # the last HISTORY statements: (text[:120], seconds)
    history: deque = field(default_factory=lambda: deque(maxlen=HISTORY))
    udf_paths: dict = field(default_factory=dict)
    dist_spmd: int = 0
    dist_fallback: int = 0
    dist_fallback_reasons: dict = field(default_factory=dict)
    tier_runs: dict = field(default_factory=dict)
    syncs_by_site: dict = field(default_factory=dict)

    def note_udf(self, path: str) -> None:
        if self.enabled:
            self.udf_paths[path] = self.udf_paths.get(path, 0) + 1

    @contextmanager
    def timed(self, phase: str):
        """Add the host time of the block to ``parse`` or else ``exec``."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if self.enabled and phase == "parse":
                self.parse_time += dt
            elif self.enabled:
                self.exec_time += dt

    def record_query(self, text: str, seconds: float) -> None:
        if self.enabled:
            self.queries += 1
            self.history.append((text[:120], seconds))

    def reset(self) -> None:
        self.parse_time = self.exec_time = 0.0
        self.queries = 0
        self.history.clear()
        self.udf_paths.clear()
        self.dist_spmd = self.dist_fallback = 0
        self.dist_fallback_reasons.clear()
        self.tier_runs.clear()
        self.syncs_by_site.clear()

    def format(self) -> str:
        lines = [
            f"Queries executed: {self.queries}",
            f"Parse time:       {self.parse_time * 1000:.3f} ms",
            f"Execution time:   {self.exec_time * 1000:.3f} ms",
        ]
        if self.udf_paths:
            lines.append("UDF paths:        " + ", ".join(
                f"{k}={v}" for k, v in sorted(self.udf_paths.items())))
        for title, counts in (("Tiers:            ", self.tier_runs),
                              ("Host syncs:       ", self.syncs_by_site)):
            if counts:
                lines.append(title + ", ".join(
                    f"{k}={v}" for k, v in sorted(counts.items())))
        if self.dist_spmd or self.dist_fallback:
            lines.append(f"Distributed SPMD: {self.dist_spmd} queries")
            lines.append(f"Mesh fallbacks:   {self.dist_fallback} queries")
            for reason, cnt in sorted(self.dist_fallback_reasons.items()):
                lines.append(f"  {cnt:6d}  {reason}")
        if self.history:
            lines.append("Recent:")
            for text, dt in self.history:
                lines.append(f"  {dt * 1000:9.3f} ms  {text}")
        return "\n".join(lines)


_current: ContextVar[QueryStats | None] = ContextVar("aq_query_stats",
                                                    default=None)


@contextmanager
def counting(stats: QueryStats):
    """Make stats the current statements' (on this thread) for the block."""
    token = _current.set(stats)
    try:
        yield
    finally:
        _current.reset(token)


def note_tier(tier: str) -> None:
    """The current statement's SELECT was answered by tier."""
    st = _current.get()
    if st is not None and st.enabled:
        st.tier_runs[tier] = st.tier_runs.get(tier, 0) + 1


def sync(site: str):
    """Count one host read of a device value at site, and return the span
    ``aq.sync.<site>`` to wrap it in."""
    st = _current.get()
    if st is not None and st.enabled:
        st.syncs_by_site[site] = st.syncs_by_site.get(site, 0) + 1
    return _Range("aq.sync." + site) if _recording() else _NULL
