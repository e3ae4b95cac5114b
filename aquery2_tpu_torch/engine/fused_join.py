"""Fused join aggregates: count(*) over an equi-join without
materializing pairs.

Counterpart of ``aquery2_tpu/engine/fused_join.py`` for one device.
``SELECT count(*) FROM a, b WHERE a.k = b.k`` is the sum, over one side's
rows, of each row's number of matches on the other side. The smaller
table builds; two routes count, each returning the count as a 0-dim int64
tensor, and try_run makes the one host sync that reads it:

  count_histogram  — integer keys whose build domain spans at most
                     ``config.PERFECT_HASH_MAX_DOMAIN`` values: one
                     index_add_ counts the build keys into domain + 1
                     int32 slots, one gather reads each probe key's count
                     (a key outside the domain reads the spare last slot,
                     0), one int64 sum.
  count_sorted     — any other keys (float keys, wide integer domains):
                     one sort of the build keys, two searchsorted of the
                     probe keys, in a dtype that holds both sides; a NaN
                     key matches nothing.

Which route is faster on the card is measured by ``chip_smoke.py`` (PERF.md
§6): at h2o qj's shape the histogram, so it takes every shape it can.
The JAX package's third route, one sort of both sides with tagged keys,
is measured there and not ported. The shape: two comma-separated tables,
a WHERE of exactly one equality between a column of each, non-string
keys, no NULLs, every projection count(*), no other clause.
"""

from __future__ import annotations

import torch

from aquery2_tpu_torch import config
from aquery2_tpu_torch import types as T
from aquery2_tpu_torch.engine.fused_groupby import output_names
from aquery2_tpu_torch.engine.fused_star import domain_codes, integer_key
from aquery2_tpu_torch.parser import ast_nodes as A
from aquery2_tpu_torch.storage.catalog import Catalog
from aquery2_tpu_torch.storage.table import Column, Table
from aquery2_tpu_torch.utils import base62uuid


def _shape(get, has, sel: A.Select):
    """The count join's (probe table, probe key, build table, build key)
    over the tables ``get(name)`` gives, the smaller side building, or
    None where the shape does not fit."""
    if (sel.group_by or sel.assumptions or sel.order_by or sel.having
            or sel.distinct or sel.unions or sel.limit is not None):
        return None
    if len(sel.sources) != 2 or not all(
            isinstance(s, A.TableSource) and has(s.name)
            for s in sel.sources):
        return None
    for p in sel.projections:
        if not (isinstance(p.expr, A.Call) and p.expr.func == "count"
                and (not p.expr.args or isinstance(p.expr.args[0], A.Star))):
            return None
    w = sel.where
    if not (isinstance(w, A.BinOp) and w.op == "="
            and isinstance(w.left, A.ColumnRef)
            and isinstance(w.right, A.ColumnRef)):
        return None
    tables = [get(s.name) for s in sel.sources]
    if any(t.has_nulls() for t in tables):
        return None

    def resolve(ref: A.ColumnRef):
        for src, tbl in zip(sel.sources, tables):
            if ref.table and ref.table.lower() not in (
                    (src.alias or src.name).lower(), src.name.lower()):
                continue
            if ref.name in tbl.columns:
                return tbl, tbl.columns[ref.name]
        return None, None

    lt, lcol = resolve(w.left)
    rt, rcol = resolve(w.right)
    if lcol is None or rcol is None or lt is rt:
        return None
    if lcol.is_vector or rcol.is_vector:
        return None
    if lcol.sqltype.is_string or rcol.sqltype.is_string:
        return None
    if lt.nrows < rt.nrows:
        return rt, rcol, lt, lcol       # the smaller side builds
    return lt, lcol, rt, rcol


def try_run(catalog: Catalog, sel: A.Select) -> Table | None:
    """The one-row result of a count join, or None where the shape does
    not fit."""
    shape = _shape(catalog.get, catalog.__contains__, sel)
    if shape is None:
        return None
    _lt, lcol, _rt, rcol = shape
    total = None
    if integer_key(lcol) and integer_key(rcol):
        mn, mx = rcol.stats()
        if mx - mn + 1 <= config.PERFECT_HASH_MAX_DOMAIN:
            total = count_histogram(lcol, rcol, mn, mx)
    if total is None:
        total = count_sorted(lcol, rcol)
    return _result(sel, int(total), lcol.device)


# the mesh's histogram route ships [domain] int32 counts per rank; above
# this domain the hash exchange of the keys moves fewer bytes (the JAX
# package's bound)
MESH_HIST_MAX_DOMAIN = 1 << 22


def try_run_mesh(session, sel: A.Select) -> Table | None:
    """The count join on a mesh session, over each rank's blocks: for an
    integer build domain of at most MESH_HIST_MAX_DOMAIN keys, each rank
    counts its build rows per key, one all_reduce adds the histograms,
    each rank reads its probe rows' counts and one all_reduce adds them;
    any other keys go through the hash exchange of both sides
    (parallel/dist_join.dist_join_counts)."""
    from aquery2_tpu_torch.parallel import comm
    from aquery2_tpu_torch.parallel.dist_join import dist_join_counts
    from aquery2_tpu_torch.parallel.mesh import local_view

    mesh, catalog = session.mesh, session.catalog
    shape = _shape(lambda nm: local_view(mesh, catalog.get(nm)),
                   catalog.__contains__, sel)
    if shape is None:
        return None
    lt, lcol, rt, rcol = shape
    session.note_spmd()
    if integer_key(lcol) and integer_key(rcol):
        mn, mx = rcol.stats()
        domain = mx - mn + 1
        if domain <= MESH_HIST_MAX_DOMAIN:
            dev = rcol.device
            code = torch.where(rt.valid, rcol.data.to(torch.int64) - mn,
                               domain)
            hist = torch.zeros(domain + 1, dtype=torch.int32, device=dev)
            hist.index_add_(0, code, torch.ones(code.shape[0],
                                                dtype=torch.int32,
                                                device=dev))
            hist = comm.all_reduce(mesh, hist[:domain], "sum")
            hist = torch.cat([hist, hist.new_zeros(1)])
            cnt = hist.index_select(0, domain_codes(lcol.data, lcol.nrows,
                                                    mn, mx))
            cnt = torch.where(lt.valid, cnt, 0).sum(dtype=torch.int64)
            total = int(comm.all_reduce(mesh, cnt.reshape(1), "sum")[0])
            return _result(sel, total, lcol.device)
    total = dist_join_counts(mesh, lcol.data, lt.valid, rcol.data, rt.valid)
    return _result(sel, total, lcol.device)


def count_histogram(pcol: Column, bcol: Column, mn: int, mx: int
                    ) -> torch.Tensor:
    """Σ over pcol's rows of the number of bcol rows holding its key;
    bcol's keys lie in [mn, mx] (its stats)."""
    domain = mx - mn + 1
    nb = bcol.nrows
    dev = bcol.device
    hist = torch.zeros(domain + 1, dtype=torch.int32, device=dev)
    hist.index_add_(0, bcol.data[:nb].to(torch.int64) - mn,
                    torch.ones(nb, dtype=torch.int32, device=dev))
    cnt = hist.index_select(0, domain_codes(pcol.data, pcol.nrows, mn, mx))
    return cnt.sum(dtype=torch.int64)


def count_sorted(pcol: Column, bcol: Column) -> torch.Tensor:
    """Σ over pcol's rows of the number of bcol rows holding an equal key,
    compared in a dtype that holds both columns' values (float64 where an
    integer column meets a float one)."""
    a, b = pcol.data.dtype, bcol.data.dtype
    dt = torch.promote_types(a, b)
    if dt.is_floating_point and not (a.is_floating_point
                                     and b.is_floating_point):
        dt = torch.float64
    keys = torch.sort(bcol.data[:bcol.nrows].to(dt)).values
    q = pcol.data[:pcol.nrows].to(dt)
    small = keys.shape[0] < 2**31
    cnt = (torch.searchsorted(keys, q, side="right", out_int32=small)
           - torch.searchsorted(keys, q, side="left", out_int32=small))
    if q.is_floating_point():
        cnt = torch.where(q.isnan(), 0, cnt)   # NaN equals nothing
    return cnt.sum(dtype=torch.int64)


def _result(sel: A.Select, total: int, device: torch.device) -> Table:
    out = Table(f"result_{base62uuid(4)}")
    names = output_names([(None, p.expr, p.alias) for p in sel.projections])
    for name in names:
        out.add_column(Column(name, T.LongT, torch.tensor(
            [total], dtype=torch.int64, device=device)))
    return out
