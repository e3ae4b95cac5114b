"""Database catalog: named tables, derived views, persistence hooks.

Counterpart of the reference's ``Context::tables`` map (server/libaquery.h:
118-161) and the Python ``Context.tables_byname`` (engine/storage.py).
"""

from __future__ import annotations

from aquery2_tpu_torch.storage.table import Table
from aquery2_tpu_torch.utils import CaseInsensitiveDict


class Catalog:
    def __init__(self) -> None:
        self.tables: CaseInsensitiveDict[Table] = CaseInsensitiveDict()

    def create(self, table: Table, replace: bool = False) -> Table:
        if table.name in self.tables and not replace:
            raise ValueError(f"table {table.name} already exists")
        self.tables[table.name] = table
        return table

    def drop(self, name: str, if_exists: bool = False) -> None:
        if name in self.tables:
            del self.tables[name]
        elif not if_exists:
            raise KeyError(f"no such table: {name}")

    def get(self, name: str) -> Table:
        try:
            return self.tables[name]
        except KeyError:
            raise KeyError(f"no such table: {name}") from None

    def __contains__(self, name: str) -> bool:
        return name in self.tables

    def names(self) -> list[str]:
        return list(self.tables)
