"""One run of one cell: set-up, the measured window, the check against
the plain reference, and the result line.

Set-up (``setup_s``, from the process's start): import the program,
load its kernel library (``ops/kernels.build``, which compiles it into
``build/aquery2_tpu_torch/`` of the checkout on a checkout's first run),
make the cell's tables on the device from the seed with the
configuration's generator, load them into one
``aquery2_tpu_torch.connect(device)`` session, and run the cell's mix
``WARMUP_CYCLES`` times.

The window: one client sends the mix's queries in a closed loop, in the
workload file's order, with no think time, in whole mixes until
``seconds`` have passed (and at least ``MIN_CYCLES`` mixes). A query is its statements through
``Session.execute`` and one ``torch.cuda.synchronize()``; its latency is
the host clock from the first call to the synchronize. Each query's
answer of one of its first ``MIN_CYCLES`` runs, drawn from the seed, is
copied to the host; the window's clock stops for the copy.

After the window (the program's state freed): the generator makes the
same tables again, the reference computes each sampled query's answer,
and ``check.compare`` holds the program's to it.

A cell of more than one chip runs this same function on each rank of a
mesh session (``world``, from ``ranks.py``): each rank places every
table, the ranks open the window together and go on or stop after each
whole mix as rank 0 decides, rank 0's clock times the queries and its
copy of the sampled answers is checked; the readings of the device are
combined over the ranks.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import sys
import time
import warnings
from collections.abc import Mapping
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from qbench import check, roofline, trace

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
MIN_CYCLES = 4
WARMUP_CYCLES = 2
GIB = 2.0**30
FORBIDDEN = ("jax", "jaxlib", "flax", "aquery2_tpu")


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_module(kind: str, name: str):
    """qbench/<kind>/<name>.py, found by name (a name may hold dots)."""
    path = ROOT / kind / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no {kind} module {name!r} at {path}")
    spec = importlib.util.spec_from_file_location(
        f"qbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Query:
    name: str
    statements: list[str]
    input_rows: int
    answer_table: str | None = None


@dataclass
class Cell:
    """A workload of BENCHMARK.json with everything it names: its
    configuration, its queries, the metrics it reports."""
    name: str
    workload: dict
    config: dict
    queries: list[Query]
    end_to_end: list[dict]
    per_layer: list[dict]


def statements(sql: str) -> list[str]:
    """The statements of a query file: split at a ';' that ends a line."""
    out, cur = [], []
    for line in sql.splitlines():
        cur.append(line)
        if line.rstrip().endswith(";"):
            out.append("\n".join(cur).strip().rstrip(";").strip())
            cur = []
    rest = "\n".join(cur).strip()
    return [s for s in out + [rest] if s]


def find_cell(name: str, manifest: dict | None = None,
              config: dict | None = None) -> Cell:
    """The cell named name in BENCHMARK.json (or manifest), its files
    found by name under qbench/; config, where given, replaces the
    configuration's file (the tests' small sizes)."""
    manifest = manifest or load_json(REPO / "BENCHMARK.json")
    wl = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if wl is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    traffic = load_json(ROOT / "workloads" / f"{name}.json")
    if (traffic["config"], traffic["chips"]) != (wl["config"], wl["chips"]):
        raise ValueError(f"workloads/{name}.json disagrees with "
                         f"BENCHMARK.json on its config or chips")
    cfg_entry = next(c for c in manifest["configs"]
                     if c["name"] == wl["config"])
    cfg = config or load_json(REPO / cfg_entry["file"])
    queries = []
    for q in traffic["queries"]:
        sql = (ROOT / "queries" / wl["config"]
               / f"{q['name']}.sql").read_text()
        queries.append(Query(q["name"], statements(sql), q["input_rows"],
                             q.get("answer_table")))
    e2e = [m for m in manifest["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    layer = [m for m in manifest["per_layer"] if name in m["workloads"]]
    return Cell(name, traffic, cfg, queries, e2e, layer)


# ---------------------------------------------------------------------- #
# the program's side: load, run, copy answers out
# ---------------------------------------------------------------------- #

class HandOver(Mapping):
    """A table's columns, each handed over once: ``items()`` takes each
    out of cols as it yields it, so that ``Table.from_numpy`` frees a
    generator column as soon as it has made its padded copy, and the
    whole table stands on the device once, not twice."""

    def __init__(self, cols: dict) -> None:
        self._cols = cols

    def __getitem__(self, name):
        return self._cols[name]

    def __iter__(self):
        return iter(list(self._cols))

    def __len__(self) -> int:
        return len(self._cols)

    def items(self):
        while self._cols:
            name = next(iter(self._cols))
            yield name, self._cols.pop(name)


class Program:
    """The session under test, with its tables loaded from the
    generator's tensors (string columns as dictionaries the harness
    makes, one a column, or one for the columns of a name that the
    generator's ``SHARED`` lists; ``strings`` keeps, by dictionary, the
    integer of each code). With a ``world`` (ranks.World), the session is
    that rank's of a mesh session, and each table is placed once made,
    the whole columns freed before the next table, so that only this
    rank's blocks stay; each generator column is freed as soon as the
    table holds its copy (``HandOver``)."""

    def __init__(self, cell: Cell, seed: int, device: torch.device,
                 world=None) -> None:
        import aquery2_tpu_torch as aq
        from aquery2_tpu_torch import types as T
        from aquery2_tpu_torch.storage.table import StringDict, Table

        self.device = device
        self.world = world
        self.db = aq.connect(device=device, **(
            world.connect_args() if world is not None else {}))
        self.db.log_level = "silent"
        gen = load_module("generators", cell.config["generator"])
        sql_type = {torch.int32: T.IntT, torch.int64: T.LongT,
                    torch.float32: T.FloatT, torch.float64: T.DoubleT}
        self.strings: dict[int, tuple[object, torch.Tensor]] = {}
        self.string_format = getattr(gen, "STRING_FORMAT", "{}")
        tables = dict(gen.make(cell.config, seed, device))
        shared = getattr(gen, "SHARED", {})
        groups: dict[object, list[tuple[str, str]]] = {}
        for tname, names in gen.STRINGS.items():
            for cname in names:
                key = cname if tname in shared.get(cname, ()) else \
                    (tname, cname)
                groups.setdefault(key, []).append((tname, cname))
        types = {t: {} for t in tables}
        dicts = {t: {} for t in tables}
        for members in groups.values():
            vals = torch.unique(torch.cat([tables[t][c]
                                           for t, c in members]))  # sorted
            d = string_dict(StringDict, self.string_format,
                            vals.cpu().numpy())
            self.strings[id(d)] = (d, vals.cpu())
            for t, c in members:
                tables[t][c] = torch.searchsorted(vals, tables[t][c]).to(
                    torch.int32)
                types[t][c], dicts[t][c] = T.StrT, d
        for tname in list(tables):
            cols = tables.pop(tname)
            for cname, t in cols.items():
                types[tname].setdefault(cname, sql_type[t.dtype])
            tbl = Table.from_numpy(
                tname, cols if world is None else HandOver(cols),
                types[tname], device=device, dictionaries=dicts[tname])
            self.db.catalog.create(tbl)
            if world is not None:
                self.db.place_table(tbl)
            del cols, tbl
        self.sync()

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, q: Query, keep: bool, spans: bool, count_syncs: bool):
        """Run q's statements, then synchronize; return q's answer (the
        last statement's result, or q.answer_table as its statements left
        it) where keep, else None."""
        db, answer = self.db, None
        for sql in q.statements:
            with _sync_debug(count_syncs):
                res = db.execute(sql)
            if keep:
                if q.answer_table:
                    answer = db.catalog.tables.get(q.answer_table, answer)
                elif res is not None:
                    answer = res.table
            del res
        with _span(spans, f"{q.name}.sync"):
            self.sync()
        return answer

    def copy_out(self, table):
        """host_copy of an answer. On a mesh every rank makes it whole
        (``Session.readable``, a collective where it is placed), rank 0
        alone copies it, and the others wait for it here, inside the
        pause, not in the next query's first collective."""
        if self.world is None:
            return host_copy(table)
        table = self.db.readable(table)
        copy = host_copy(table) if self.world.rank == 0 else None
        self.world.barrier()
        return copy

    def close(self) -> None:
        self.db.close()
        self.db = None


def string_dict(cls, fmt: str, keys: np.ndarray):
    """cls(fmt.format(k) for k in keys), the codes in keys' order, built
    in bulk: the strings in one join and split, the index in one dict
    call, where the class keeps the list and the index that its
    constructor fills one string at a time; else by its constructor."""
    head, tail = fmt.split("{}")
    strs = (head + (tail + "\n" + head).join(map(str, keys.tolist()))
            + tail).split("\n") if len(keys) else []
    d = cls()
    if strs and {"_strings", "_index"} <= set(getattr(cls, "__slots__", ())):
        d._strings = strs
        d._index = dict(zip(strs, range(len(strs))))
        if (len(d) == len(d._index) == len(strs)
                and d.lookup(strs[-1]) == len(strs) - 1):
            return d
    return cls(strs)


def host_copy(table) -> list[tuple]:
    """An answer table's columns on the host: (name, values, valid,
    offsets, dictionary), a string column as its codes."""
    if table is None:
        return None
    out = []
    for c in table.columns.values():
        if c.sqltype.is_vector:
            out.append((c.name, c.values[:c.total_values()].cpu(), None,
                        c.offsets[:c.nrows + 1].cpu(), None))
            continue
        valid = None if c.valid is None else c.valid[:c.nrows].cpu()
        d = c.dictionary if c.sqltype.is_string else None
        out.append((c.name, c.data[:c.nrows].cpu(), valid, None, d))
    return out


def plain_answer(cols, strings: dict, string_format: str):
    """check.Answer of a host copy: a string column as the integers of its
    strings (by the generator's format), through the dictionary the
    harness made, else by decoding each string."""
    if cols is None:
        return None
    ans = check.Answer({})
    for name, vals, valid, offsets, d in cols:
        if d is not None:
            if id(d) in strings and strings[id(d)][0] is d:
                vals = strings[id(d)][1][vals.long()]
            else:
                head, tail = string_format.split("{}")
                txt = d.decode(vals.numpy())
                vals = torch.tensor([int(s[len(head):len(s) - len(tail)])
                                     if s is not None else 0 for s in txt],
                                    dtype=torch.int32)
        ans.columns[name] = vals
        if valid is not None:
            ans.valid[name] = valid
        if offsets is not None:
            ans.offsets[name] = offsets
    return ans


@contextlib.contextmanager
def _sync_debug(on: bool):
    if not on:
        yield
        return
    torch.cuda.set_sync_debug_mode("warn")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _span(on: bool, name: str):
    if not on:
        return contextlib.nullcontext()
    return torch.profiler.record_function(trace.PREFIX + name)


@contextlib.contextmanager
def instrumented(program: Program, calls: list, on: bool):
    """While on: a span around each parse and each statement's execution
    (wrapping the session's parse and its executor's execute), and each
    hand-kernel call's bytes appended to calls (wrapping the four entry
    points of ops/kernels)."""
    if not on:
        yield
        return
    from aquery2_tpu_torch import session as S
    from aquery2_tpu_torch.ops import kernels as K

    current = {"q": "?"}
    real_parse, executor = S.parse, program.db.executor
    real_exec = executor.execute
    real_k = {e: getattr(K, e) for e in roofline.ENTRY_POINTS}

    def parse(text):
        with _span(True, f"{current['q']}.parse"):
            return real_parse(text)

    def execute(stmt):
        with _span(True, f"{current['q']}.execute"):
            return real_exec(stmt)

    def recorder(entry, fn):
        def call(*args, **kw):
            calls.append((entry, roofline.call_bytes(entry, args)))
            return fn(*args, **kw)
        return call

    S.parse, executor.execute = parse, execute
    for e, fn in real_k.items():
        setattr(K, e, recorder(e, fn))
    try:
        yield current
    finally:
        S.parse = real_parse
        del executor.execute
        for e, fn in real_k.items():
            setattr(K, e, fn)


# ---------------------------------------------------------------------- #
# one run
# ---------------------------------------------------------------------- #

def percentile(values: list[float], p: float) -> float:
    """The p-th percentile, numpy's linear interpolation."""
    return float(np.percentile(np.asarray(values), p))


@dataclass
class Loop:
    """What the closed loop of one window gives: each completed query's
    latency (s), the queries attempted and their failures, the input
    rows of the completed ones, the window's length without the pauses
    (s), whole mixes, and the sampled answers' host copies."""
    latencies: list[float]
    errors: list[str]
    attempted: int
    rows: int
    window_s: float
    cycles: int
    answers: dict[str, list]


def closed_loop(program: Program, cell: Cell, seconds: float,
                sample_at: dict[str, int], traced: bool,
                current: dict | None) -> Loop:
    """One client, the mix in order, no think time, whole mixes until
    seconds have passed (and at least MIN_CYCLES mixes), so that every
    query of the mix weighs alike in the rate and the percentiles; the
    clock stops while a sampled answer is copied to the host. On a mesh
    rank 0's clock decides after each whole mix for every rank, and a
    query that raises ends the run: the other ranks wait in its
    collectives."""
    on_card = program.device.type == "cuda"
    out = Loop([], [], 0, 0, 0.0, 0, {})
    runs = {q.name: 0 for q in cell.queries}
    paused = 0.0
    t0 = time.perf_counter()
    while _go_on(time.perf_counter() - t0 - paused < seconds
                 or out.cycles < MIN_CYCLES, program.world):
        for q in cell.queries:
            keep = runs[q.name] == sample_at[q.name]
            runs[q.name] += 1
            out.attempted += 1
            if current is not None:
                current["q"] = q.name
            t1 = time.perf_counter()
            try:
                with _span(traced, q.name):
                    ans = program.run(q, keep, traced, traced and on_card)
            except Exception as exc:        # counted, and not correct
                out.errors.append(f"{q.name}: {exc!r}"[:500])
                if program.world is not None:
                    raise
                program.sync()
                continue
            t2 = time.perf_counter()
            out.latencies.append(t2 - t1)
            out.rows += q.input_rows
            if keep:
                with _span(traced, "sample_copy"):
                    out.answers[q.name] = program.copy_out(ans)
                paused += time.perf_counter() - t2
            del ans
        out.cycles += 1
    out.window_s = time.perf_counter() - t0 - paused
    return out


def _go_on(go: bool, world) -> bool:
    """go, or on a mesh rank 0's go on every rank: one broadcast a whole
    mix, outside every query's latency."""
    return go if world is None else world.agree(go)


def end_to_end(loop: Loop, peak_bytes: int, setup_s: float) -> dict:
    """The end-to-end metrics of one window: the input rows of every
    completed query over the window, the median and 95th percentile of
    every query's latency, the memory peak and the set-up."""
    return {"rows_per_s": loop.rows / loop.window_s,
            "query_p50_ms": percentile(loop.latencies, 50) * 1e3,
            "query_p95_ms": percentile(loop.latencies, 95) * 1e3,
            "peak_mem_gib": peak_bytes / GIB, "setup_s": setup_s}


def memory_peak(device: torch.device) -> int:
    """The device's memory peak since its last reset, bytes (0 off a
    card)."""
    return (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)


def run(cell: Cell, seed: int, seconds: float, traced: bool,
        device: torch.device, t_start: float, log=None,
        world=None) -> dict | None:
    """One run of cell; returns the result line's object. With a world
    (ranks.World), this rank's part of the run: rank 0 returns the
    result line's object, every other rank None."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    on_card = device.type == "cuda"
    if on_card:
        from aquery2_tpu_torch.ops import kernels as K
        K.build()
        log(f"# kernels loaded ({time.perf_counter() - t_start:.1f} s)")
    program = Program(cell, seed, device, world)
    log(f"# tables made and loaded ({time.perf_counter() - t_start:.1f} s)")
    for _ in range(WARMUP_CYCLES):
        for q in cell.queries:
            program.run(q, False, False, False)
    rng = np.random.default_rng(seed)
    sample_at = {q.name: int(rng.integers(0, MIN_CYCLES))
                 for q in cell.queries}
    setup_peak = memory_peak(device)
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    parse0 = program.db.stats.parse_time
    window = trace.Window()
    prof = (torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU] + (
        [torch.profiler.ProfilerActivity.CUDA] if on_card else []))
        if traced else contextlib.nullcontext())
    if world is not None:
        world.barrier()                 # the ranks open the window together
    setup_s = time.perf_counter() - t_start
    log(f"# warmed up; the window opens ({setup_s:.1f} s)")
    with warnings.catch_warnings(record=True) as caught, prof:
        warnings.simplefilter("always")
        with instrumented(program, window.kernel_calls, traced) as current:
            loop = closed_loop(program, cell, seconds, sample_at, traced,
                               current)
    peak = memory_peak(device)
    window.syncs = sum(1 for w in caught if "synchroniz" in str(w.message))
    window.queries = len(loop.latencies)
    window.parse_s = program.db.stats.parse_time - parse0
    name = torch.cuda.get_device_name(device) if on_card else "cpu"
    window.hbm_bytes_per_s = roofline.HBM_BYTES_PER_S.get(name)
    if traced:
        trace.read_profile(prof, window)
    if world is not None:
        peak, setup_peak = world.combine(peak, setup_peak, window)
    log(f"# the window closed: {window.queries} queries in "
        f"{loop.window_s:.3f} s ({loop.cycles} whole mixes), "
        f"{len(loop.errors)} failed")
    for e in loop.errors[:5]:
        log(f"# failed: {e}")

    metrics = {}
    if not traced:
        values = end_to_end(loop, peak, setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
        n = len(loop.latencies)
        log(f"# {n} latencies, p50 and p95 over all of them: "
            f"{n - int(0.95 * n)} beyond the 95th percentile")
    else:
        for m in cell.per_layer:
            v = load_module("metrics", m["name"]).read(window)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = {"platform": "gpu" if on_card else "cpu", "kind": name,
                   "count": cell.workload["chips"],
                   "memory_peak_bytes": max(peak, setup_peak)}
    if traced:
        device_info["busy_s"] = window.busy_s
        device_info["window_s"] = window.window_s

    strings, fmt = program.strings, program.string_format
    program.close()
    del program
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    if world is not None:
        world.barrier()                 # every rank's state is freed
        if world.rank:
            return None
    checks = reference_checks(cell, seed, device, loop.answers, strings, fmt,
                              log)
    correct = not loop.errors and all(v <= lim for v, lim in checks.values())
    out = {"correct": correct, "attempted": loop.attempted,
           "failed": len(loop.errors), "metrics": metrics,
           "device": device_info}
    if traced:
        out["breakdown"] = window.breakdown()
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    return out


def scaled(config: dict, rows: int) -> dict:
    """The configuration at another size (the tests' and the control's
    small runs), as its generator scales it."""
    return load_module("generators", config["generator"]).scaled(config,
                                                                 rows)


def make_tables(cell: Cell, seed: int, device) -> dict:
    """The cell's tables, as the generator makes them from seed."""
    gen = load_module("generators", cell.config["generator"])
    return {t: cols for t, cols in gen.make(cell.config, seed, device)}


def reference_fn(config: str, query: str):
    """The reference of query: qbench/reference/<config>.<query>.py's
    ``answer`` where that file exists, else the function named query of
    qbench/reference/<config>.py."""
    if (ROOT / "reference" / f"{config}.{query}.py").exists():
        return load_module("reference", f"{config}.{query}").answer
    return getattr(load_module("reference", config), query)


def compare_all(cell: Cell, tables: dict, answer_of) -> tuple[dict, dict]:
    """({"<query>.schema" and "<query>.cells" of each query, and "float"
    (the largest over the cell's queries, held to the workload file's
    ``float_limit``): (reading, limit)}, {query: its float reading}):
    each query's answer_of(q, its reference function) against the
    reference's answer over tables."""
    config = cell.workload["config"]
    checks, floats = {}, {}
    for q in cell.queries:
        fn = reference_fn(config, q.name)
        want = fn(tables)
        res = check.compare(answer_of(q, fn), want)
        checks[f"{q.name}.schema"] = (res["schema"], 0)
        checks[f"{q.name}.cells"] = (res["cells"], 0)
        if want.floats:
            floats[q.name] = res["float"]
        del want
    if floats:
        checks["float"] = (max(floats.values()),
                           cell.workload["float_limit"])
    return checks, floats


def reference_checks(cell: Cell, seed: int, device, answers: dict,
                     strings: dict, fmt: str, log) -> dict:
    """The program's sampled answers against the reference, computed on
    the device over the same tables made again from the seed."""
    t0 = time.perf_counter()
    tables = make_tables(cell, seed, device)

    def program_answer(q, fn):
        got = plain_answer(answers.get(q.name), strings, fmt)
        return None if got is None else got.to(device)
    checks, floats = compare_all(cell, tables, program_answer)
    log(f"# reference: {len(cell.queries)} answers compared "
        f"({time.perf_counter() - t0:.1f} s); float by query: {floats}")
    return checks


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole."""
    return sorted({m for m in sys.modules
                   if m.split(".", 1)[0] in FORBIDDEN})

