"""Session: the public entry point.

    >>> import aquery2_tpu_torch as aq
    >>> db = aq.connect()                    # device="cuda"
    >>> db.execute("CREATE TABLE t(a INT, b INT)")
    >>> db.execute("INSERT INTO t VALUES (1,2),(1,3),(2,5)")
    >>> print(db.execute("SELECT a, sum(b) FROM t GROUP BY a").format())

Counterpart of ``aquery2_tpu/session.py``: a catalog of tables on one
device, the user FUNCTIONs, the query stats (``stats``), the directory
that relative file paths resolve against (``base_dir``: LOAD DATA
INFILE, INTO OUTFILE) and statement execution. Every tensor the session
makes lives on ``session.device``. Procedures, triggers and attached
data sources (ROADMAP item 8b) and the mesh (item 9) are not here.
"""

from __future__ import annotations

import os
import time

import torch

from aquery2_tpu_torch.engine.executor import Executor
from aquery2_tpu_torch.parser import ast_nodes as A
from aquery2_tpu_torch.parser import parse
from aquery2_tpu_torch.runtime.stats import QueryStats
from aquery2_tpu_torch.storage.catalog import Catalog
from aquery2_tpu_torch.storage.result import Result
from aquery2_tpu_torch.utils import CaseInsensitiveDict


class Session:
    def __init__(self, device: torch.device | str,
                 base_dir: str | None = None) -> None:
        self.device = torch.device(device)
        self.catalog = Catalog()
        self.udfs: CaseInsensitiveDict = CaseInsensitiveDict()  # FUNCTIONs
        self.stats = QueryStats()
        self.base_dir = base_dir or os.getcwd()
        self.log_level = "info"             # "info" | "error" | "silent"
        self.executor = Executor(self)

    def resolve_path(self, path: str) -> str:
        """A path of a statement: absolute, or under ``base_dir``."""
        if os.path.isabs(path):
            return path
        return os.path.join(self.base_dir, path)

    # log, log_error and log_level have no caller in the port yet: the
    # JAX package's callers are triggers and the REPL (ROADMAP 8b, 8c).
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
        last: Result | None = None
        t0 = time.perf_counter()
        with self.stats.timed("exec"):
            for stmt in stmts:
                r = self.executor.execute(stmt)
                if r is not None:
                    last = r
        self.stats.record_query(text.strip(), time.perf_counter() - t0)
        return last

    sql = execute

    def run_script(self, stmts: list[A.Statement]) -> Result | None:
        """Execute parsed statements in order; returns the last Result."""
        last = None
        for stmt in stmts:
            r = self.executor.execute(stmt)
            if r is not None:
                last = r
        return last

    def close(self) -> None:
        """Nothing to release yet: the session holds no threads, files or
        connections (the JAX package's close stops triggers and attached
        sources, ROADMAP item 8b). Tables go with the session."""

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def connect(device: torch.device | str = "cuda",
            base_dir: str | None = None) -> Session:
    """A session whose tables live on ``device`` and whose relative file
    paths resolve under ``base_dir`` (default: the working directory).
    The default device is the CUDA card; without one this raises (nothing
    moves to the CPU unasked): pass device="cpu" to run on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("connect(device='cuda'): no CUDA device is "
                           "available; pass device='cpu' to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return Session(device, base_dir=base_dir)
