"""The plain reference of db-benchmark's five join questions over J1 (x,
small, medium, big): one function a query, by its name, in plain
PyTorch on whatever device the tables are on.

Each takes the generator's tables ({"x": {column: tensor}, ...}; a
string column as the integers k of its strings "id<k>") and returns the
table that ``CREATE TABLE ans AS SELECT ...`` leaves, as
``check.Answer``: x's columns, then the right table's, in the SQL's
order and the program's types (ids int32, strings as the int32 k, v1 and
v2 float64). An inner join keeps each x row once for each right row
whose key equals its key; LEFT JOIN keeps an x row with no such right
row once, its right columns NULL. x.id3 takes each key of its pool once,
so it orders the rows (the right tables' join keys are unique as well).
Every cell is compared exactly: the values are copies of the input.
``fdtype`` is the type v1 and v2 pass through: float64 as the
configuration states; the control passes float32.

Imports torch and qbench.check: nothing of the program.
"""

from __future__ import annotations

import torch

from qbench.check import Answer

X = ["id1", "id2", "id3", "id4", "id5", "id6", "v1"]


def join(t, right: str, key: str, cols: dict[str, str],
         left_outer: bool = False, fdtype=torch.float64) -> Answer:
    """x JOIN right USING (key): x's columns, then cols (output name ->
    right column)."""
    x, r = t["x"], t[right]
    order = torch.argsort(r[key], stable=True)
    rk = r[key][order]
    lo = torch.searchsorted(rk, x[key], right=False)
    hi = torch.searchsorted(rk, x[key], right=True)
    cnt = hi - lo
    if left_outer:
        cnt = torch.clamp(cnt, min=1)
    xi = torch.repeat_interleave(torch.arange(cnt.shape[0],
                                              device=cnt.device), cnt)
    first = torch.repeat_interleave(lo, cnt)
    start = torch.cumsum(cnt, 0) - cnt
    at = first + torch.arange(xi.shape[0], device=cnt.device) - \
        torch.repeat_interleave(start, cnt)
    hit = at < torch.repeat_interleave(hi, cnt)
    ri = order[torch.where(hit, at, 0)]
    copy = lambda v: v.to(fdtype).to(v.dtype) if v.is_floating_point() \
        else v  # noqa: E731
    out = {c: copy(x[c][xi]) for c in X}
    valid = {}
    for name, c in cols.items():
        out[name] = copy(r[c][ri])
        if left_outer:
            valid[name] = hit
    return Answer(out, ["id3"], [], valid)


def j1_q1(t, fdtype=torch.float64) -> Answer:
    return join(t, "small", "id1", {"small_id4": "id4", "v2": "v2"},
                fdtype=fdtype)


def j1_q2(t, fdtype=torch.float64) -> Answer:
    return join(t, "medium", "id2", {"medium_id1": "id1",
                                     "medium_id4": "id4",
                                     "medium_id5": "id5", "v2": "v2"},
                fdtype=fdtype)


def j1_q3(t, fdtype=torch.float64) -> Answer:
    return join(t, "medium", "id2", {"medium_id1": "id1",
                                     "medium_id4": "id4",
                                     "medium_id5": "id5", "v2": "v2"},
                left_outer=True, fdtype=fdtype)


def j1_q4(t, fdtype=torch.float64) -> Answer:
    return join(t, "medium", "id5", {"medium_id1": "id1",
                                     "medium_id2": "id2",
                                     "medium_id4": "id4", "v2": "v2"},
                fdtype=fdtype)


def j1_q5(t, fdtype=torch.float64) -> Answer:
    return join(t, "big", "id3", {"big_id1": "id1", "big_id2": "id2",
                                  "big_id4": "id4", "big_id5": "id5",
                                  "big_id6": "id6", "v2": "v2"},
                fdtype=fdtype)
