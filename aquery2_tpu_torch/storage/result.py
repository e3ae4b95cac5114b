"""Query results: rows, formatting, scalars.

Counterpart of ``aquery2_tpu/storage/result.py``: rows, the text
table, the CSV file of SELECT … INTO OUTFILE (``to_csv``) and a pandas
DataFrame (``to_pandas``, which imports pandas only when called).
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

    def to_csv(self, path: str, sep: str = ",", header: bool = True) -> None:
        """The rows as a CSV file (INTO OUTFILE writes no header). A
        vector cell is its elements joined by ';', as the reference
        prints it; a NULL is an empty cell."""
        with open(path, "w") as f:
            if header:
                f.write(sep.join(self.column_names()) + "\n")
            for row in self.rows():
                f.write(sep.join(";".join(_fmt_value(x) for x in v)
                                 if isinstance(v, (list, tuple))
                                 else _fmt_value(v) for v in row) + "\n")

    def to_pandas(self):
        """The rows as a pandas DataFrame (pandas is imported here: the
        port does not need it otherwise)."""
        import pandas as pd

        return pd.DataFrame({c.name: c.to_python()
                             for c in self.table.columns.values()})

    def to_dict(self) -> dict[str, list]:
        """Each column's display values, by name."""
        return {c.name: c.to_python() for c in self.table.columns.values()}

    def __repr__(self) -> str:
        return self.format(limit=20)
