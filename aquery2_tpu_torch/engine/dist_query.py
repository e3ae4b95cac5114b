"""Distributed fused group-by: grouped and ungrouped aggregates over the
ranks' blocks.

Counterpart of ``aquery2_tpu/engine/dist_query.py``. Each rank reduces its
block of the table (parallel/mesh.local_view) with the single-device fused
tier's helpers (engine/fused_groupby.py), and the ranks' partials merge:

  dense    — each rank's perfect-hash slots ([domain + 1], the
             onehot_segment_sums kernel), then one all_reduce per (dtype,
             op) over every lane: sums add, mins and maxes take the
             extreme. Traffic O(domain), none of it rows.
  packed / — each rank sorts its rows by key (fused_groupby.sorted_groups)
  multikey   and reduces them to partial groups (ops/reduce.
             sorted_group_reduce: seg_cumsum_i64 for sums, seg_scan_multi
             for min/max), at most one per row. The partials merge as
             the JAX package's default (owner) merge does: each partial
             group goes to the rank its key hashes to (one split-size
             all_to_all), which reduces it again with the same kernels;
             every group then exists on exactly one rank, and one
             all_gather gives every rank every group once, which it
             orders by key. (The JAX package's replicated merge, kept
             there for A/B, is not ported.)

Aggregates decompose as in the JAX package: count, sum, avg, var,
stddev and corr are sums (float32 sums in the exact integer limbs of
fused_groupby._build_lanes, which merge losslessly), min and max are
extremes. Groups come out key-ascending, as on one device.

What the JAX package needs for XLA's static shapes is gone: its owner
merge packs fixed-capacity buckets, retries with doubled caps and falls
back to the replicated merge when a bucket still overflows; here the
exchange is sized by a first trade of counts and never overflows.

The median does not decompose into partials: its queries go to
engine/dist_ordered.run_median, which moves each group's rows to one
rank.
"""

from __future__ import annotations

import torch

from aquery2_tpu_torch.engine import dist_ordered
from aquery2_tpu_torch.engine import fused_groupby as fg
from aquery2_tpu_torch.ops import reduce as R
from aquery2_tpu_torch.ops.sort import lexsort
from aquery2_tpu_torch.parallel import comm
from aquery2_tpu_torch.parallel.dist_join import destinations
from aquery2_tpu_torch.parallel.mesh import block_column, local_view
from aquery2_tpu_torch.parser import ast_nodes as A
from aquery2_tpu_torch.storage.table import Table

def _sentinel_null_keys(p, local):
    """fused_groupby.sentinel_code_null_keys on the ranks' blocks: each
    nullable integer key column coded NULL → (global max) + 1, so the
    NULLs form one group on every rank. (local', sentinels) or None."""
    cols = local.columns
    key_names = [k.name.lower() for k in p["keys"]
                 if isinstance(k, A.ColumnRef)]
    if len(key_names) != len(p["keys"]):
        return None
    nullable_keys = [kn for kn in key_names
                     if kn in cols and cols[kn].valid is not None]
    if not nullable_keys:
        return None
    other_refs: set[str] = set()
    for kindp, expr, _ in p["projections"]:
        if kindp != "key":
            other_refs |= fg._refs(expr)
    for e in (p["where"], p["having"]):
        if e is not None:
            other_refs |= fg._refs(e)
    if other_refs & set(nullable_keys):
        return None
    sents: dict[str, int] = {}
    coded = []
    for c in cols.values():
        nm = c.name.lower()
        if nm not in nullable_keys:
            coded.append(c)
            continue
        if c.data.is_floating_point() or c.data.dtype == torch.bool:
            return None
        mn, mx = c.stats()
        if mn > mx:                     # all NULL: the stats are sentinels
            mn, mx = 0, 0
        sent = mx + 1
        if sent > torch.iinfo(c.data.dtype).max:
            return None
        coded.append(block_column(
            c.name, c.sqltype, torch.where(c.valid, c.data, sent)
            .to(c.data.dtype), None, c.dictionary, _Stats((mn, sent))))
        sents[nm] = sent
    out = type(local)(local.name, coded, local.n, local.valid, local.gidx)
    return out, sents


class _Stats:
    """Fixed global stats for a derived block column."""

    def __init__(self, stats=None, fsum=None) -> None:
        self._s, self._f = stats, fsum

    def stats(self):
        return self._s

    def float_summary(self):
        return self._f


def _prepare(session, p, local):
    """The shared NULL gate: (cols, col_order, nullable) or None (the
    reason noted)."""
    cols = local.columns
    col_order = fg.referenced_columns(p)
    nullable, bail = fg.nullable_gate(p, cols, col_order)
    if bail:
        session.note_dist_bail(bail)
        return None
    return cols, col_order, nullable


def _rows(p, cols, col_order, nullable, local):
    env = {nm: cols[nm].data for nm in col_order}
    env_null = {nm: ~cols[nm].valid for nm in sorted(nullable)}
    valid = local.valid
    if p["where"] is not None:
        valid = valid & fg._truth(fg._as_rows(fg._row_eval(p["where"], env),
                                              valid))
    null_fn = fg.make_null_fn(env_null) if env_null else None
    return env, env_null, valid, null_fn


def run(session, sel: A.Select, table: Table) -> Table | None:
    """The grouped query over the mesh, or None (the caller goes on to
    the gathered single-device tiers; the reason is noted)."""
    mesh = session.mesh
    if mesh is None:
        return None
    try:
        p = fg.plan(sel, table)
    except fg.Unsupported as e:
        session.note_dist_bail(f"unsupported shape: {e}")
        return None
    if p["has_median"]:
        # the median does not decompose into partials: each group's rows
        # go to one rank, where the sort tier's median is exact
        return dist_ordered.run_median(session, sel, table, p)
    local = local_view(mesh, table)
    n = local.n
    if n == 0:
        session.note_dist_bail("empty table")
        return None
    sub = _sentinel_null_keys(p, local)
    if sub is not None:
        local, p["key_sentinels"] = sub
    got = _prepare(session, p, local)
    if got is None:
        return None
    cols, col_order, nullable = got
    strategy, key_mins, key_ranges, domain = fg.choose_strategy(p, cols)
    scatters = fg._needed_scatters(p["aggs"])
    env, env_null, valid, null_fn = _rows(p, cols, col_order, nullable,
                                          local)
    if not fg.float_sums_fit(scatters, cols, n,
                             lambda e: fg._row_eval(e, env), valid, null_fn,
                             reduce=dist_ordered.all_max(mesh)):
        session.note_dist_bail("float sums outside the exact lanes")
        return None
    session.note_spmd()
    if strategy == "dense":
        dense, counts, keyvals = _run_dense(mesh, p, env, valid, null_fn,
                                            scatters, key_mins, key_ranges,
                                            domain)
    else:
        packed = strategy == "packed" and \
            fg._plan_words(key_ranges) is not None
        dense, counts, keyvals = _run_sortmerge(
            mesh, p, env, env_null, valid, scatters, key_mins, key_ranges,
            packed)
    return fg.finish_groups(p, cols, dense, counts, keyvals)


# --------------------------------------------------------------------- #
# dense tier: local slots, one all_reduce per (dtype, op)
# --------------------------------------------------------------------- #

def _combine_slots(mesh, outs, mins, maxs):
    """Every rank's [domain + 1] slot lanes combined: sums add, extremes
    take their min or max (one all_reduce per dtype and op)."""
    sums = {t: v for t, v in outs.items() if t not in mins and t not in maxs}
    comb = comm.all_reduce_lanes(mesh, sums, "sum")
    if mins:
        comb.update(comm.all_reduce_lanes(mesh, {t: outs[t] for t in mins},
                                          "min"))
    if maxs:
        comb.update(comm.all_reduce_lanes(mesh, {t: outs[t] for t in maxs},
                                          "max"))
    return comb


def _run_dense(mesh, p, env, valid, null_fn, scatters, key_mins,
               key_ranges, domain):
    strides = []
    s = 1
    for r in reversed(key_ranges):
        strides.append(s)
        s *= r
    strides.reverse()
    code = None
    for k, mn, st in zip(p["keys"], key_mins, strides):
        part = (env[k.name.lower()].to(torch.int64) - mn) * st
        code = part if code is None else code + part
    code = torch.where(valid, code, domain).to(torch.int32)
    add, mins, maxs, f64s = fg._build_lanes(env, valid, scatters,
                                            null_fn=null_fn)
    outs = R.segment_reduce(code, add, mins, maxs, f64s, domain)
    outs = _combine_slots(mesh, outs, mins, maxs)
    ucodes = torch.nonzero(outs["__counts__"][:domain] > 0).squeeze(1)
    dense = {t: arr[ucodes] for t, arr in outs.items()}
    keyvals = [(ucodes // st) % r + mn
               for st, r, mn in zip(strides, key_ranges, key_mins)]
    return dense, dense["__counts__"], keyvals


# --------------------------------------------------------------------- #
# sort tiers: local partial groups, then the owner or replicated merge
# --------------------------------------------------------------------- #

def _key_entries(p, env, valid, key_mins, key_ranges, packed):
    """The sort keys of each row (lexsort entries) and how to read the
    key values back from the sorted keys."""
    keys = p["keys"]
    if packed:
        fields, nwords = fg._plan_words(key_ranges)
        dev = valid.device
        words = [torch.zeros(valid.shape, dtype=torch.int32, device=dev)
                 for _ in range(nwords)]
        for ki, k in enumerate(keys):
            wi, shift, _b = fields[ki]
            words[wi] |= ((env[k.name.lower()].to(torch.int64)
                           - key_mins[ki]).to(torch.int32) << shift)
        return [(w, True, b)
                for w, b in zip(words, fg.word_bounds(fields, nwords))]
    bounds = ([(mn, mn + r - 1) for mn, r in zip(key_mins, key_ranges)]
              or [None] * len(keys))
    kv = [fg._as_rows(fg._row_eval(k, env), valid) for k in keys]
    return [(v, True) if b is None else (v, True, b)
            for v, b in zip(kv, bounds)]


def _key_values(p, gkeys, key_mins, key_ranges, packed):
    if not packed:
        return list(gkeys)
    fields, _nwords = fg._plan_words(key_ranges)
    out = []
    for ki in range(len(p["keys"])):
        wi, shift, b = fields[ki]
        out.append(((gkeys[wi] >> shift) & ((1 << b) - 1)) + key_mins[ki])
    return out


def _reduce_sorted(entries, valid, add, mins, maxs, f64s):
    """Group rows by entries (sorted_groups) and reduce the lanes,
    gathered by the sort, over the runs: (per-group lanes, the groups'
    keys)."""
    perm, _valid_s, sk, starts, last = fg.sorted_groups(valid, entries)
    g = lambda d: {t: v[perm] for t, v in d.items()}          # noqa: E731
    outs, _ends = R.sorted_group_reduce(
        starts, last, g(add), g(mins), g(maxs), g(f64s),
        extract={f"__key{i}": x for i, x in enumerate(sk[:len(entries)])})
    keys = [outs.pop(f"__key{i}") for i in range(len(entries))]
    return outs, keys


def _run_sortmerge(mesh, p, env, env_null, valid, scatters, key_mins,
                   key_ranges, packed):
    entries = _key_entries(p, env, valid, key_mins, key_ranges, packed)
    # this rank's partial groups (the packed tier's local stage)
    perm, valid_s, sk, starts, last = fg.sorted_groups(valid, entries)
    add, mins, maxs, f64s = fg._sorted_lanes(env, env_null, perm, valid_s,
                                             scatters)
    part, _ends = R.sorted_group_reduce(
        starts, last, add, mins, maxs, f64s,
        extract={f"__key{i}": x for i, x in enumerate(sk[:len(entries)])},
        counts_from_ends="__counts__")
    pkeys = [part.pop(f"__key{i}") for i in range(len(entries))]
    kinds = {t: ("min" if t in mins else "max" if t in maxs
                 else "f64" if t in f64s else "add") for t in part}
    tags = sorted(part)
    bounds = [e[2] if len(e) > 2 else None for e in entries]

    def merge(keys, lanes):
        """One reduction of partial groups (keys, tag → lane) into
        groups: sums of sums, extremes of extremes."""
        ok = torch.ones(keys[0].shape, dtype=torch.bool,
                        device=keys[0].device)
        ents = [(k, True) if b is None else (k, True, b)
                for k, b in zip(keys, bounds)]
        return _reduce_sorted(
            ents, ok,
            {t: v for t, v in lanes.items() if kinds[t] == "add"},
            {t: v for t, v in lanes.items() if kinds[t] == "min"},
            {t: v for t, v in lanes.items() if kinds[t] == "max"},
            {t: v for t, v in lanes.items() if kinds[t] == "f64"})

    # the owner merge: each partial group to the rank its key hashes to,
    # reduced there; then every group, once, to every rank, key-ordered
    nk = len(pkeys)
    dest = destinations(mesh, pkeys)
    recv = comm.all_to_all_v(mesh, dest, pkeys + [part[t] for t in tags])
    lanes, keys = _merge_received(merge, recv[:nk],
                                  dict(zip(tags, recv[nk:])))
    got, _sizes = comm.all_gather_v(mesh, keys + [lanes[t] for t in tags])
    gkeys, glanes = got[:nk], dict(zip(tags, got[nk:]))
    order = lexsort([(k, True) if b is None else (k, True, b)
                     for k, b in zip(gkeys, bounds)])[0]
    dense = {t: v[order] for t, v in glanes.items()}
    gkeys = [k[order] for k in gkeys]
    counts = dense["__counts__"]
    return dense, counts, _key_values(p, gkeys, key_mins, key_ranges, packed)


def _merge_received(merge, keys, lanes):
    """merge() of received partials; a rank that received none merges
    nothing and gives no group (the scans never see an empty input)."""
    if keys[0].shape[0]:
        return merge(keys, lanes)
    return dict(lanes), list(keys)


# --------------------------------------------------------------------- #
# ungrouped tier: one slot, one all_reduce per (dtype, op)
# --------------------------------------------------------------------- #

def run_ungrouped(session, sel: A.Select, table: Table) -> Table | None:
    """SELECT agg(expr)… FROM t [WHERE …] over the mesh: the dense tier
    with one slot. None where the shape does not fit (the reason noted
    where the JAX package notes one)."""
    mesh = session.mesh
    if mesh is None:
        return None
    if (sel.group_by or sel.assumptions or sel.distinct or sel.unions
            or sel.having or sel.order_by):
        return None
    if len(sel.sources) != 1 or not isinstance(sel.sources[0],
                                               A.TableSource):
        return None
    cols = table.columns
    if table_rows(table) == 0:
        session.note_dist_bail("empty table")
        return None
    try:
        aggs: list[A.Call] = []
        projections = []
        for pr in sel.projections:
            e = pr.expr
            if isinstance(e, A.Star):
                raise fg.Unsupported("star")
            before = len(aggs)
            fg._collect_aggs(e, cols, aggs)
            if len(aggs) == before and fg._refs(e):
                raise fg.Unsupported("row projection in ungrouped agg")
            projections.append(("agg", e, pr.alias))
        if not projections:
            raise fg.Unsupported("no projections")
        if any(a.func == "median" for a in aggs):
            raise fg.Unsupported("median does not decompose into partials")
        if sel.where is not None:
            fg._check_row_expr(sel.where, cols)
    except fg.Unsupported as e:
        session.note_dist_bail(f"unsupported shape: {e}")
        return None

    p = {"keys": [], "projections": projections, "aggs": aggs,
         "where": sel.where, "limit": sel.limit, "having": None,
         "order_by": [], "expr_keys": False, "has_median": False}
    local = local_view(mesh, table)
    got = _prepare(session, p, local)
    if got is None:
        return None
    cols, col_order, nullable = got
    scatters = fg._needed_scatters(aggs)
    env, _env_null, valid, null_fn = _rows(p, cols, col_order, nullable,
                                           local)
    if not fg.float_sums_fit(scatters, cols, local.n,
                             lambda e: fg._row_eval(e, env), valid, null_fn,
                             reduce=dist_ordered.all_max(mesh)):
        session.note_dist_bail("float sums outside the exact lanes")
        return None
    session.note_spmd()
    code = torch.where(valid, 0, 1).to(torch.int32)
    add, mins, maxs, f64s = fg._build_lanes(env, valid, scatters,
                                            null_fn=null_fn)
    outs = R.segment_reduce(code, add, mins, maxs, f64s, 1)
    outs = _combine_slots(mesh, outs, mins, maxs)
    dense = {t: a[:1] for t, a in outs.items()}
    counts = dense["__counts__"]
    results = [fg._as_rows(fg._post_agg_eval(expr, dense, counts), counts)
               for _, expr, _ in projections]
    return fg._finish(p, cols, results, 1)


def table_rows(table) -> int:
    """The global row count of a table or of a rank's view of one."""
    return table.n if hasattr(table, "n") else table.nrows
