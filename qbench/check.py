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

An answer too large to check whole on one device is checked in blocks:
``block_of`` puts each row in a block by a hash of its key columns, the
same for a row of the input and for the answer's row that it makes, and
``compare_parts`` gives each block's raw parts, which ``combine`` turns
into the three numbers above: the largest schema, the sum of the cells,
and the float error as max |got - want| over the blocks over max |want|
over the blocks. ``compare`` is ``combine`` of one whole block.

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
    """ans with its rows ordered by its key columns, in place: each
    column is replaced as it is permuted, so that a large answer stands
    on the device once, not twice."""
    if not keys or ans.nrows <= 1:
        return ans
    n = ans.nrows
    dev = next(iter(ans.columns.values())).device
    perm = lexsort([ans.columns[k] for k in keys], n, dev)
    for name in list(ans.columns):
        if name in ans.offsets:
            ans.columns[name], ans.offsets[name] = permute_ragged(
                ans.columns[name], ans.offsets[name], perm)
        else:
            ans.columns[name] = ans.columns[name][perm]
    for name in list(ans.valid):
        ans.valid[name] = ans.valid[name][perm]
    return ans


def _cells(got: torch.Tensor, want: torch.Tensor, gv, wv) -> int:
    """Cells that differ, NULL masks included; a NULL's value is not
    compared."""
    gv = torch.ones_like(want, dtype=torch.bool) if gv is None else gv
    wv = torch.ones_like(want, dtype=torch.bool) if wv is None else wv
    same = (got == want) | (got.isnan() & want.isnan()
                            if want.is_floating_point() else False)
    bad = (gv != wv) | (wv & ~same)
    return int(bad.sum())


def _float_parts(got: torch.Tensor, want: torch.Tensor, gv,
                 wv) -> tuple[float, float] | None:
    """(max |got - want|, max |want|) over the rows where both are not
    NULL, or None where a value is not finite."""
    both = torch.ones_like(want, dtype=torch.bool)
    if gv is not None:
        both &= gv
    if wv is not None:
        both &= wv
    g = got.to(torch.float64)[both]
    w = want.to(torch.float64)[both]
    if w.numel() == 0:
        return 0.0, 0.0
    if not (bool(torch.isfinite(g).all()) and bool(torch.isfinite(w).all())):
        return None
    return float((g - w).abs().max()), float(w.abs().max())


def _ncells(ans: Answer) -> int:
    return sum(int(c.numel()) for c in ans.columns.values())


def compare_parts(got: Answer | None, want: Answer | None) -> dict:
    """The raw parts of got against want, which ``combine`` turns into
    the readings: {"schema", "cells", "floats": {column: (max |got -
    want|, max |want|)}, "worst": whether float reads WORST, "has_floats":
    whether want has float columns}. want None is a block of an answer in
    which no row is expected: each cell got has there is wrong."""
    if want is None:
        return {"schema": 0, "cells": 0 if got is None else _ncells(got),
                "floats": {}, "worst": False, "has_floats": False}
    ncells = _ncells(want)
    worst = {"schema": len(want.columns), "cells": ncells, "floats": {},
             "worst": True, "has_floats": bool(want.floats)}
    if got is None:
        return worst
    names = set(got.columns) | set(want.columns)
    schema = sum(1 for name in names
                 if name not in got.columns or name not in want.columns
                 or got.columns[name].dtype != want.columns[name].dtype)
    if schema == 0 and list(got.columns) != list(want.columns):
        schema = 1                              # the same columns, reordered
    if schema or got.nrows != want.nrows:
        # no row expected where got has some: each of its cells is wrong
        return {**worst, "schema": schema, "cells": ncells or _ncells(got)}
    got, want = _ordered(got, want.keys), _ordered(want, want.keys)
    cells, floats, bad = 0, {}, False
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
            part = _float_parts(g, w, gv, wv)
            bad |= part is None
            floats[name] = part or (0.0, 0.0)
        else:
            cells += _cells(g, w, gv, wv)
    return {"schema": schema, "cells": cells, "floats": floats,
            "worst": bad, "has_floats": bool(want.floats)}


def combine(parts: list[dict]) -> dict[str, float]:
    """{"schema", "cells", "float"} of the parts of an answer's blocks:
    the largest schema, the sum of the cells, and for float the largest
    over the columns of (max |got - want| over the blocks) / (max |want|
    over the blocks), the number the whole answer gives."""
    schema = max((p["schema"] for p in parts), default=0)
    cells = sum(p["cells"] for p in parts)
    if any(p["worst"] for p in parts):
        return {"schema": schema, "cells": cells, "float": WORST}
    err: dict[str, float] = {}
    scale: dict[str, float] = {}
    for p in parts:
        for name, (e, s) in p["floats"].items():
            err[name] = max(err.get(name, 0.0), e)
            scale[name] = max(scale.get(name, 0.0), s)
    ferr = 0.0
    for name, e in err.items():
        ferr = max(ferr, e / scale[name] if scale[name] > 0 else e)
    return {"schema": schema, "cells": cells, "float": ferr}


def compare(got: Answer | None, want: Answer) -> dict[str, float]:
    """{"schema", "cells", "float"} of got against want (see the module
    docstring); a missing answer reads worst on each."""
    return combine([compare_parts(got, want)])


# ---------------------------------------------------------------------- #
# blocks by a hash of the key columns
# ---------------------------------------------------------------------- #

CHUNK_ROWS = 1 << 24        # rows hashed at a time: int64 temporaries of
                            # 128 MiB, whatever the answer's length
MAX_BLOCKS = 1024


def _i64(c: int) -> int:
    """An unsigned 64-bit constant as the int64 with its bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


_GOLD = _i64(0x9E3779B97F4A7C15)
_MUL1 = _i64(0xBF58476D1CE4E5B9)
_MUL2 = _i64(0x94D049BB133111EB)


def _shr(h: torch.Tensor, s: int) -> torch.Tensor:
    """h >> s, logical (torch's is arithmetic)."""
    return (h >> s) & ((1 << (64 - s)) - 1)


def _mix(h: torch.Tensor) -> torch.Tensor:
    """splitmix64's finalizer, in int64 that wraps."""
    h = (h ^ _shr(h, 30)) * _MUL1
    h = (h ^ _shr(h, 27)) * _MUL2
    return h ^ _shr(h, 31)


def block_of(keys: list[torch.Tensor], blocks: int) -> torch.Tensor:
    """Each row's block, int16 in [0, blocks): a fixed 64-bit mix of the
    row's key values, each taken as its low 32 bits, mod blocks. Computed
    CHUNK_ROWS rows at a time, so that no int64 temporary spans every
    row; the same on every device."""
    n = int(keys[0].shape[0])
    out = torch.empty(n, dtype=torch.int16, device=keys[0].device)
    for c0 in range(0, n, CHUNK_ROWS):
        h = None
        for k in keys:
            v = k[c0:c0 + CHUNK_ROWS].to(torch.int64) & 0xFFFFFFFF
            h = _mix((v if h is None else h ^ v) + _GOLD)
        out[c0:c0 + CHUNK_ROWS] = torch.remainder(h, blocks)
    return out
