"""Query results: rows, formatting, scalars.

Counterpart of ``aquery2_tpu/storage/result.py`` (its CSV and pandas
exports wait for the services layer, ROADMAP queue 1, item 8).
"""

from __future__ import annotations

import io
from typing import Any

import numpy as np

from aquery2_tpu_torch.storage.table import Table


def _fmt_value(v: Any) -> str:
    if v is None:
        return ""
    if isinstance(v, float):
        return f"{v:.10g}"
    if isinstance(v, np.floating):
        return _fmt_value(float(v))
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_fmt_value(x) for x in v) + "]"
    return str(v)


class Result:
    """Wraps an output table; knows how to list and print its rows."""

    def __init__(self, table: Table) -> None:
        self.table = table

    @property
    def nrows(self) -> int:
        return self.table.nrows

    def column_names(self) -> list[str]:
        return self.table.column_names()

    def rows(self, limit: int | None = None) -> list[tuple]:
        cols = [c.to_python() for c in self.table.columns.values()]
        n = self.table.nrows if limit is None else min(limit, self.table.nrows)
        return [tuple(col[i] for col in cols) for i in range(n)]

    def scalar(self) -> Any:
        """First cell, for single-value results."""
        r = self.rows(limit=1)
        return r[0][0] if r else None

    def format(self, sep: str = " | ", limit: int | None = None) -> str:
        buf = io.StringIO()
        names = self.column_names()
        buf.write(sep.join(names) + "\n")
        buf.write(sep.join("=" * max(len(n), 3) for n in names) + "\n")
        shown = 0
        for row in self.rows(limit=limit):
            buf.write(sep.join(_fmt_value(v) for v in row) + "\n")
            shown += 1
        if limit is not None and self.table.nrows > shown:
            buf.write(f"... ({self.table.nrows - shown} more rows)\n")
        return buf.getvalue()

    def to_dict(self) -> dict[str, list]:
        """Each column's display values, by name."""
        return {c.name: c.to_python() for c in self.table.columns.values()}

    def __repr__(self) -> str:
        return self.format(limit=20)
