"""The comparison that decides ``correct``: one answer of the program
against the plain reference's, every row and every column.

Both sides come as an ``Answer``: plain tensors by column name, in the
column order of the SQL, on one device. A string column holds the
integer each string stands for (the generator's "id<k>" is k), so the
reference never sees a dictionary. ``compare`` sorts both sides' rows by
the answer's key columns and gives three numbers, each held to a limit:

* ``schema``: columns whose name or dtype differ, or that one side
  lacks (limit 0);
* ``cells``: cells that differ, among the columns compared exactly (the
  keys, every integer, every NULL mask, a vector column's lengths and
  values, and the floats that are copies or order statistics of the
  input); with a row count that differs, every expected cell (limit 0);
* ``float``: the largest normwise relative error of a column the
  reference computes in floating point (sums, averages, moments):
  max |got - want| / max |want| over the rows where both are not NULL
  (the harness holds the largest over a cell's queries to the workload
  file's ``float_limit``).

Imports torch only: nothing of the program.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

# what a number reads where it cannot be computed (JSON has no inf)
WORST = 1e300


@dataclass
class Answer:
    """columns: name -> values (one per row; a vector column's flat
    values), in SQL order. valid: name -> bool mask, where a column has
    NULLs. offsets: name -> int64 row offsets of a vector column (rows + 1
    entries). keys: the columns that identify a row (exact). floats: the
    columns compared by normwise relative error (all others exactly)."""
    columns: dict[str, torch.Tensor]
    keys: list[str] = field(default_factory=list)
    floats: list[str] = field(default_factory=list)
    valid: dict[str, torch.Tensor] = field(default_factory=dict)
    offsets: dict[str, torch.Tensor] = field(default_factory=dict)

    @property
    def nrows(self) -> int:
        for name, col in self.columns.items():
            if name in self.offsets:
                return int(self.offsets[name].shape[0]) - 1
            return int(col.shape[0])
        return 0

    def to(self, device) -> "Answer":
        move = lambda d: {k: v.to(device) for k, v in d.items()}  # noqa: E731
        return Answer(move(self.columns), list(self.keys), list(self.floats),
                      move(self.valid), move(self.offsets))


def lexsort(keys: list[torch.Tensor], n: int, device) -> torch.Tensor:
    """The permutation that orders rows by keys[0], then keys[1], ...:
    one stable sort per key, the last key first."""
    perm = torch.arange(n, device=device)
    for k in reversed(keys):
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm


def permute_ragged(values: torch.Tensor, offsets: torch.Tensor,
                   perm: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """A vector column's rows in the order perm: (values, offsets)."""
    lens = (offsets[1:] - offsets[:-1])[perm]
    starts = offsets[:-1][perm]
    new_off = torch.zeros(lens.shape[0] + 1, dtype=torch.int64,
                          device=offsets.device)
    torch.cumsum(lens, 0, out=new_off[1:])
    total = int(new_off[-1])
    shift = torch.repeat_interleave(starts - new_off[:-1], lens,
                                    output_size=total)
    idx = shift + torch.arange(total, device=offsets.device)
    return values[idx], new_off


def _ordered(ans: Answer, keys: list[str]) -> Answer:
    """ans with its rows ordered by its key columns."""
    if not keys or ans.nrows <= 1:
        return ans
    n = ans.nrows
    dev = next(iter(ans.columns.values())).device
    perm = lexsort([ans.columns[k] for k in keys], n, dev)
    cols, offs = {}, {}
    for name, col in ans.columns.items():
        if name in ans.offsets:
            cols[name], offs[name] = permute_ragged(col, ans.offsets[name],
                                                    perm)
        else:
            cols[name] = col[perm]
    valid = {k: v[perm] for k, v in ans.valid.items()}
    return Answer(cols, ans.keys, ans.floats, valid, offs)


def _cells(got: torch.Tensor, want: torch.Tensor, gv, wv) -> int:
    """Cells that differ, NULL masks included; a NULL's value is not
    compared."""
    gv = torch.ones_like(want, dtype=torch.bool) if gv is None else gv
    wv = torch.ones_like(want, dtype=torch.bool) if wv is None else wv
    same = (got == want) | (got.isnan() & want.isnan()
                            if want.is_floating_point() else False)
    bad = (gv != wv) | (wv & ~same)
    return int(bad.sum())


def _float_err(got: torch.Tensor, want: torch.Tensor, gv, wv) -> float:
    both = torch.ones_like(want, dtype=torch.bool)
    if gv is not None:
        both &= gv
    if wv is not None:
        both &= wv
    g = got.to(torch.float64)[both]
    w = want.to(torch.float64)[both]
    if w.numel() == 0:
        return 0.0
    if not (bool(torch.isfinite(g).all()) and bool(torch.isfinite(w).all())):
        return WORST
    scale = float(w.abs().max())
    err = float((g - w).abs().max())
    return err / scale if scale > 0 else err


def compare(got: Answer | None, want: Answer) -> dict[str, float]:
    """{"schema", "cells", "float"} of got against want (see the module
    docstring); a missing answer reads worst on each."""
    ncells = sum(int(c.numel()) for c in want.columns.values())
    if got is None:
        return {"schema": len(want.columns), "cells": ncells, "float": WORST}
    names = set(got.columns) | set(want.columns)
    schema = sum(1 for name in names
                 if name not in got.columns or name not in want.columns
                 or got.columns[name].dtype != want.columns[name].dtype)
    if schema == 0 and list(got.columns) != list(want.columns):
        schema = 1                              # the same columns, reordered
    if schema or got.nrows != want.nrows:
        return {"schema": schema, "cells": ncells, "float": WORST}
    got, want = _ordered(got, want.keys), _ordered(want, want.keys)
    cells, ferr = 0, 0.0
    for name, w in want.columns.items():
        g = got.columns[name]
        if name in want.offsets:
            go, wo = got.offsets[name], want.offsets[name]
            cells += int((go != wo).sum())
            if g.shape != w.shape:
                cells += int(w.numel())
                continue
        gv, wv = got.valid.get(name), want.valid.get(name)
        if name in want.floats:
            if gv is not None or wv is not None:
                cells += _cells(torch.zeros_like(w), torch.zeros_like(w),
                                gv, wv)
            ferr = max(ferr, _float_err(g, w, gv, wv))
        else:
            cells += _cells(g, w, gv, wv)
    return {"schema": schema, "cells": cells, "float": ferr}
