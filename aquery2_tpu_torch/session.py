"""Session: the public entry point.

    >>> import aquery2_tpu_torch as aq
    >>> db = aq.connect()                    # device="cuda"
    >>> db.execute("CREATE TABLE t(a INT, b INT)")
    >>> db.execute("INSERT INTO t VALUES (1,2),(1,3),(2,5)")
    >>> print(db.execute("SELECT a, sum(b) FROM t GROUP BY a").format())

Counterpart of ``aquery2_tpu/session.py``: a catalog of tables on one
device, the user FUNCTIONs, and statement execution. Every tensor the
session makes lives on ``session.device``.
"""

from __future__ import annotations

import torch

from aquery2_tpu_torch.engine.executor import Executor
from aquery2_tpu_torch.parser import parse
from aquery2_tpu_torch.storage.catalog import Catalog
from aquery2_tpu_torch.storage.result import Result
from aquery2_tpu_torch.utils import CaseInsensitiveDict


class Session:
    def __init__(self, device: torch.device | str) -> None:
        self.device = torch.device(device)
        self.catalog = Catalog()
        self.udfs: CaseInsensitiveDict = CaseInsensitiveDict()  # FUNCTIONs
        self.executor = Executor(self)

    def execute(self, text: str) -> Result | None:
        """Parse and execute a statement batch; returns the last Result."""
        last: Result | None = None
        for stmt in parse(text):
            r = self.executor.execute(stmt)
            if r is not None:
                last = r
        return last

    sql = execute


def connect(device: torch.device | str = "cuda") -> Session:
    """A session whose tables live on ``device``. The default is the CUDA
    card; without one this raises (nothing moves to the CPU unasked):
    pass device="cpu" to run on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("connect(device='cuda'): no CUDA device is "
                           "available; pass device='cpu' to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return Session(device)
