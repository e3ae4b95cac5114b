"""The plain reference of the h2o group-by questions q1-q10 over G1: one
function a query, by its name, in plain PyTorch on whatever device the
table is on.

Each takes the generator's tables ({"source": {column: tensor}}) and
returns the answer as ``check.Answer``: the columns of the SQL, in its
order and in the program's SQL types (keys int32, integer sums and
counts int64, averages, float sums and moments float64, q7's difference
int32, q8's vectors float64 as v3), the key columns that order the rows,
and the columns computed in floating point (compared by normwise
relative error, the rest exactly).

Semantics, as the AQuery dialect defines them (the program's own
documentation: ``aquery2_tpu_torch/ops/agg.py``): integer sums are exact
in int64; avg is the sum over the count in float64; median is the mean
of the two middle values of a group (one where the count is odd);
var divides by n + 1 (the reference engine's server/aggregations.h, kept
under ``config.STRICT_REFERENCE_SEMANTICS``) and sums a DOUBLE column's
values and squares in float64, as db-benchmark's R ``sd`` does; stddev is its root; corr is the Pearson correlation from raw moments (exact integer sums, then
float64); subvec(v3, 0, 2) under ASSUMING DESC v3 is a group's two
largest v3 in descending order (one where the group has one row).

``BLOCK_KEYS`` names each query's GROUP BY columns, the keys of its
answer: a row of the answer holds the key values of the input rows it
comes from, so a check may cut both to one block of a hash of those
columns (``harness.compare_all``).
``fdtype`` is the floating type every float sum, average and moment is
computed in: float64 as the configuration states; the control passes
float32. Imports torch and qbench.check: nothing of the program.
"""

from __future__ import annotations

import torch

from qbench.check import Answer, lexsort

F64 = torch.float64

BLOCK_KEYS = {"q1": ["id1"], "q2": ["id1", "id2"], "q3": ["id3"],
              "q4": ["id4"], "q5": ["id6"], "q6": ["id4", "id5"],
              "q7": ["id3"], "q8": ["id6"], "q9": ["id2", "id4"],
              "q10": ["id1", "id2", "id3", "id4", "id5", "id6"]}


def group(keys: list[torch.Tensor]):
    """Key-ascending groups: (unique key columns, each row's group, each
    group's count)."""
    n = keys[0].shape[0]
    perm = lexsort(keys, n, keys[0].device)
    sk = [k[perm] for k in keys]
    new = torch.zeros(n, dtype=torch.bool, device=keys[0].device)
    new[0] = True
    for k in sk:
        new[1:] |= k[1:] != k[:-1]
    gs = torch.cumsum(new, 0) - 1
    inv = torch.empty_like(gs)
    inv[perm] = gs
    return [k[new] for k in sk], inv, torch.bincount(gs)


def isum(inv, v, g) -> torch.Tensor:
    return torch.zeros(g, dtype=torch.int64, device=v.device).index_add_(
        0, inv, v.to(torch.int64))


def fsum(inv, v, g, fdtype) -> torch.Tensor:
    return torch.zeros(g, dtype=fdtype, device=v.device).index_add_(
        0, inv, v.to(fdtype))


def _grouped(src, names: list[str]):
    keys, inv, cnt = group([src[k] for k in names])
    return dict(zip(names, keys)), inv, cnt


def q1(t, fdtype=F64) -> Answer:
    s = t["source"]
    keys, inv, cnt = _grouped(s, ["id1"])
    return Answer({**keys, "v1": isum(inv, s["v1"], len(cnt))}, ["id1"])


def q2(t, fdtype=F64) -> Answer:
    s = t["source"]
    keys, inv, cnt = _grouped(s, ["id1", "id2"])
    return Answer({**keys, "v1": isum(inv, s["v1"], len(cnt))},
                  ["id1", "id2"])


def q3(t, fdtype=F64) -> Answer:
    s = t["source"]
    keys, inv, cnt = _grouped(s, ["id3"])
    g = len(cnt)
    v3 = fsum(inv, s["v3"], g, fdtype) / cnt.to(fdtype)
    return Answer({**keys, "v1": isum(inv, s["v1"], g), "v3": v3.to(F64)},
                  ["id3"], ["v3"])


def q4(t, fdtype=F64) -> Answer:
    s = t["source"]
    keys, inv, cnt = _grouped(s, ["id4"])
    g, n = len(cnt), cnt.to(fdtype)
    avg = {"v1": isum(inv, s["v1"], g).to(fdtype) / n,
           "v2": isum(inv, s["v2"], g).to(fdtype) / n,
           "v3": fsum(inv, s["v3"], g, fdtype) / n}
    return Answer({**keys, **{k: v.to(F64) for k, v in avg.items()}},
                  ["id4"], ["v1", "v2", "v3"])


def q5(t, fdtype=F64) -> Answer:
    s = t["source"]
    keys, inv, cnt = _grouped(s, ["id6"])
    g = len(cnt)
    return Answer({**keys, "v1": isum(inv, s["v1"], g),
                   "v2": isum(inv, s["v2"], g),
                   "v3": fsum(inv, s["v3"], g, fdtype).to(F64)},
                  ["id6"], ["v3"])


def q6(t, fdtype=F64) -> Answer:
    s = t["source"]
    keys, inv, cnt = _grouped(s, ["id4", "id5"])
    g = len(cnt)
    v = s["v3"]
    order = lexsort([inv, v], v.shape[0], v.device)
    sv = v[order].to(fdtype)
    starts = torch.cumsum(cnt, 0) - cnt
    median = (sv[starts + (cnt - 1) // 2] + sv[starts + cnt // 2]) * 0.5
    vf = v.to(fdtype)
    s1 = fsum(inv, vf, g, fdtype)
    s2 = fsum(inv, vf * vf, g, fdtype)
    den = cnt.to(fdtype) + 1
    sd = torch.sqrt(torch.clamp((s2 - s1 * s1 / den) / den, min=0))
    return Answer({**keys, "median_v3": median.to(F64), "sd": sd.to(F64)},
                  ["id4", "id5"], ["sd"])


def q7(t, fdtype=F64) -> Answer:
    s = t["source"]
    keys, inv, cnt = _grouped(s, ["id3"])
    g = len(cnt)
    mx = torch.empty(g, dtype=torch.int32, device=inv.device).scatter_reduce_(
        0, inv, s["v1"], "amax", include_self=False)
    mn = torch.empty(g, dtype=torch.int32, device=inv.device).scatter_reduce_(
        0, inv, s["v2"], "amin", include_self=False)
    return Answer({**keys, "range_v1_v2": mx - mn}, ["id3"])


def q8(t, fdtype=F64) -> Answer:
    s = t["source"]
    keys, inv, cnt = _grouped(s, ["id6"])
    v = s["v3"]
    desc = torch.sort(v, descending=True, stable=True).indices
    order = desc[torch.sort(inv[desc], stable=True).indices]
    starts = torch.cumsum(cnt, 0) - cnt
    kept = torch.clamp(cnt, max=2)
    offsets = torch.zeros(len(cnt) + 1, dtype=torch.int64, device=v.device)
    torch.cumsum(kept, 0, out=offsets[1:])
    first = torch.repeat_interleave(starts, kept)
    within = torch.arange(first.shape[0], device=v.device) - \
        torch.repeat_interleave(offsets[:-1], kept)
    top2 = v[order[first + within]]
    return Answer({**keys, "largest2_v3": top2}, ["id6"],
                  offsets={"largest2_v3": offsets})


def q9(t, fdtype=F64) -> Answer:
    s = t["source"]
    keys, inv, cnt = _grouped(s, ["id2", "id4"])
    g = len(cnt)
    x, y = s["v1"].to(torch.int64), s["v2"].to(torch.int64)
    sx, sy, sxy, sx2, sy2 = (isum(inv, a, g).to(fdtype)
                             for a in (x, y, x * y, x * x, y * y))
    n = cnt.to(fdtype)
    r = (n * sxy - sx * sy) / torch.sqrt((n * sx2 - sx * sx)
                                         * (n * sy2 - sy * sy))
    return Answer({**keys, "r2": (r * r).to(F64)}, ["id2", "id4"], ["r2"])


def q10(t, fdtype=F64) -> Answer:
    s = t["source"]
    names = ["id1", "id2", "id3", "id4", "id5", "id6"]
    keys, inv, cnt = _grouped(s, names)
    return Answer({**keys, "v3": fsum(inv, s["v3"], len(cnt), fdtype)
                   .to(F64), "cnt": cnt.to(torch.int64)}, names, ["v3"])
