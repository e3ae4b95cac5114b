"""Session: the public entry point.

    >>> import aquery2_tpu_torch as aq
    >>> db = aq.connect()                    # device="cuda"
    >>> db.execute("CREATE TABLE t(a INT, b INT)")
    >>> db.execute("INSERT INTO t VALUES (1,2),(1,3),(2,5)")
    >>> print(db.execute("SELECT a, sum(b) FROM t GROUP BY a").format())

Counterpart of ``aquery2_tpu/session.py``: a catalog of tables on one
device, the user FUNCTIONs, the functions of loaded modules (LOAD
MODULE, sdk/modules.py), stored procedures (``procedures``; a batch is
recorded while one records), triggers (``triggers``, whose threads
``close`` stops), attached SQL backends (``attach``, ``backend_exec``,
``backend_append``), the query stats (``stats``), the directory that
relative file paths resolve against (``base_dir``: LOAD DATA INFILE,
INTO OUTFILE, LOAD MODULE, the procedures' .aqp files) and statement
execution. Every tensor the session makes lives on ``session.device``.

A mesh session (``connect(mesh=N, ...)`` on every rank of a process group
of N, parallel/mesh.py) row-shards each table it places over the ranks
(``place_table``; LOAD, INSERT, DELETE, UPDATE and CREATE TABLE AS place
their table again), runs the queries its distributed tiers take over the
ranks' blocks (``note_spmd``), and any other statement over tables
gathered back whole (``note_dist_bail``, counted as a fallback in
``stats``). Every rank issues the same statements and gets the whole
result.
"""

from __future__ import annotations

import os
import time

import torch

from aquery2_tpu_torch.engine.executor import ExecError, Executor
from aquery2_tpu_torch.parser import ast_nodes as A
from aquery2_tpu_torch.parser import parse
from aquery2_tpu_torch.runtime.procedures import ProcedureStore
from aquery2_tpu_torch.runtime.stats import QueryStats, counting, span
from aquery2_tpu_torch.runtime.triggers import TriggerHost
from aquery2_tpu_torch.storage.catalog import Catalog
from aquery2_tpu_torch.storage.result import Result
from aquery2_tpu_torch.utils import CaseInsensitiveDict


class Session:
    def __init__(self, device: torch.device | str,
                 base_dir: str | None = None, mesh=None) -> None:
        self.device = torch.device(device)
        self.mesh = mesh                    # parallel.mesh.Mesh or None
        # per-SELECT distributed-path accounting (engine/executor.py sets
        # these around each SELECT; the dist tiers report through them)
        self._dist_hit = False
        self._dist_reason: str | None = None
        self._warned_fallbacks: set[str] = set()
        self.catalog = Catalog()
        self.udfs: CaseInsensitiveDict = CaseInsensitiveDict()  # FUNCTIONs
        self.module_functions: CaseInsensitiveDict = CaseInsensitiveDict()
        self.stats = QueryStats()
        self.triggers = TriggerHost(self)
        self.procedures = ProcedureStore(self)
        self.sources: dict[str, object] = {}     # attached backends by alias
        self.base_dir = base_dir or os.getcwd()
        self.log_level = "info"             # "info" | "error" | "silent"
        self.executor = Executor(self)

    # -- the mesh ----------------------------------------------------------

    def note_spmd(self) -> None:
        """A distributed tier runs the current SELECT over the ranks."""
        self._dist_hit = True

    def note_dist_bail(self, reason: str) -> None:
        """A distributed tier declined the current SELECT; the first
        reason is the one counted if no other tier takes it."""
        if self._dist_reason is None:
            self._dist_reason = reason

    def _record_mesh_fallback(self, reason: str) -> None:
        self.stats.dist_fallback += 1
        self.stats.dist_fallback_reasons[reason] = \
            self.stats.dist_fallback_reasons.get(reason, 0) + 1
        if reason not in self._warned_fallbacks:
            self._warned_fallbacks.add(reason)
            self.log(f"mesh session: query ran on gathered tables "
                     f"({reason}); further occurrences counted in `stats`.")

    def place_table(self, tbl) -> None:
        """Row-shard a table's scalar columns over the mesh, each rank
        keeping its block (parallel/mesh.place_table); a no-op without a
        mesh. Every rank places the same table."""
        if self.mesh is not None:
            from aquery2_tpu_torch.parallel.mesh import place_table

            place_table(self.mesh, tbl)

    def readable(self, tbl, names: set[str] | None = None):
        """A table as single-device code reads it: a placed table's
        columns (those of ``names``, lower case, where given) gathered
        whole on every rank; any other table as it is."""
        if self.mesh is None:
            return tbl
        from aquery2_tpu_torch.parallel.mesh import gather_table

        return gather_table(self.mesh, tbl, names)

    def resolve_path(self, path: str) -> str:
        """A path of a statement: absolute, or under ``base_dir``."""
        if os.path.isabs(path):
            return path
        return os.path.join(self.base_dir, path)

    def log(self, msg: str) -> None:
        if self.log_level == "info":
            print(msg)

    def log_error(self, msg: str) -> None:
        if self.log_level != "silent":
            print(f"error: {msg}")

    def execute(self, text: str) -> Result | None:
        """Parse and execute a statement batch; returns the last Result.
        Its parse and execution times go to ``stats`` (host time: no
        synchronize is added, runtime/stats.py)."""
        with self.stats.timed("parse"):
            stmts = parse(text)
        t0 = time.perf_counter()
        if stmts and self.procedures.recording is not None:
            self.procedures.record(text.strip())
        with self.stats.timed("exec"):
            last = self.run_script(stmts)
        self.stats.record_query(text.strip(), time.perf_counter() - t0)
        return last

    sql = execute

    def run_script(self, stmts: list[A.Statement]) -> Result | None:
        """Execute parsed statements in order, each in its span
        ``aq.execute``, counting tiers and host syncs into ``stats``;
        returns the last Result."""
        last = None
        with counting(self.stats):
            for stmt in stmts:
                with span("execute"):
                    r = self.executor.execute(stmt)
                if r is not None:
                    last = r
        return last

    # -- attached SQL backends (storage/datasource.py) ----------------------

    def attach(self, alias: str, source) -> None:
        """Attach a SQL backend under ``alias``: a DataSource, a DB-API
        connection, or a SQLite spec (a path under ``base_dir``,
        ``sqlite:<path>`` or ``:memory:``)."""
        from aquery2_tpu_torch.storage.datasource import (DataSource,
                                                          DBAPISource,
                                                          open_source)

        if isinstance(source, str):
            if source != ":memory:" and not source.startswith("sqlite:"):
                source = self.resolve_path(source)
            source = open_source(source)
        elif not isinstance(source, DataSource):
            source = DBAPISource(source)
        self.sources[alias.lower()] = source

    def detach(self, alias: str) -> None:
        src = self.sources.pop(alias.lower(), None)
        if src is not None:
            src.close()

    def _source(self, alias: str):
        src = self.sources.get(alias.lower())
        if src is None:
            raise ExecError(f"no attached backend {alias!r}; use attach()")
        return src

    def backend_exec(self, alias: str, sql: str, into: str | None = None):
        """Run SQL on an attached backend; a statement that returns rows
        comes back as a Table on ``device`` (in the catalog as ``into``
        or ``backend_result``), any other as None."""
        return self._source(alias).exec(sql, session=self, into=into)

    def backend_append(self, alias: str, table_name: str,
                       target: str | None = None) -> None:
        """Write a table of the catalog into an attached backend (CREATE
        TABLE IF NOT EXISTS, then its rows)."""
        self._source(alias).append_table(
            self.readable(self.catalog.get(table_name)), target or table_name)

    # -- stored procedures and triggers ------------------------------------

    def run_procedure(self, name: str) -> Result | None:
        return self.procedures.run(name)

    def notify_insert(self, table_name: str) -> None:
        """Rows went into ``table_name``: queue its conditional triggers."""
        self.triggers.notify_insert(table_name)

    def close(self) -> None:
        """Stop the trigger threads and close the attached backends.
        Tables go with the session."""
        self.triggers.shutdown()
        for src in self.sources.values():
            try:
                src.close()
            except Exception:
                pass
        self.sources.clear()

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def connect(device: torch.device | str = "cuda",
            base_dir: str | None = None, mesh: int | None = None,
            coordinator: str | None = None,
            num_processes: int | None = None,
            process_id: int | None = None,
            backend: str | None = None) -> Session:
    """A session whose tables live on ``device`` and whose relative file
    paths resolve under ``base_dir`` (default: the working directory).
    The default device is the CUDA card; without one this raises (nothing
    moves to the CPU unasked): pass device="cpu" to run on the CPU.

    mesh: the number of ranks (a power of two) to row-shard tables over;
    None or 1 is the single-device session. Every rank calls connect with
    the same mesh. The process group is joined here from
    ``coordinator`` ("host:port"), ``num_processes`` and ``process_id``
    (or AQ_COORDINATOR / AQ_NUM_PROCESSES / AQ_PROCESS_ID, or torchrun's
    env://) with ``backend`` ("nccl" or "gloo"; by default nccl on a CUDA
    device, gloo on the CPU), or found where it exists; without one, or
    of another size, this raises (parallel/multihost.py)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("connect(device='cuda'): no CUDA device is "
                           "available; pass device='cpu' to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    m = None
    if mesh is not None and mesh > 1:
        from aquery2_tpu_torch.parallel import multihost
        from aquery2_tpu_torch.parallel.mesh import make_mesh

        if mesh & (mesh - 1):
            raise ValueError("mesh size must be a power of two")
        multihost.initialize(coordinator, num_processes, process_id,
                             backend=backend, device=device)
        m = make_mesh(mesh, device)
    return Session(device, base_dir=base_dir, mesh=m)
