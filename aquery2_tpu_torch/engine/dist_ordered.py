"""Distributed median and ordered (ASSUMING) group-bys: each row moves to
the rank that owns its group key, and the single-device tiers run there
over complete groups.

Counterpart of ``aquery2_tpu/engine/dist_ordered.py``. A median and the
ordered tier's running, windowed and subvec projections do not decompose
into per-rank partials, but groups are independent: once every row of a
group sits on one rank, the single-device code is exact there. So:

  1. every rank evaluates WHERE over its block and sends each kept row,
     with every column the statement reads and the NULL masks of the
     nullable ones, to the rank its key hashes to (``shuffle``: one
     count exchange, then one comm.all_to_all_v of the rows packed as
     bytes). The key travels as one packed int32 word where every key is
     an integer column whose global stats fit one word (the JAX
     package's _WordKey), else as the key expressions' values
     (_MultiKey); strings as their global dictionary codes;
  2. the received rows form a rank-local table of block columns that
     carry the table's global stats, so the single-device planner takes
     the same tier and lane layout on every rank; they arrive in global
     row order (rank r's block precedes rank r + 1's, and the exchange
     keeps each sender's order), so the stable local sorts keep ties in
     input order, as one device does;
  3. each rank reduces its groups (``run_median``: fused_groupby's sort
     tiers with the median argument as the secondary sort key;
     ``run_ordered``: fused_ordered.ordered_groups), and one all_gather_v
     gives every rank every group once, which it orders by key (codes
     for a string key, as the JAX package's merge sorts its key lanes);
     a ragged projection's values follow their groups.

A rank that receives no row reduces a one-row table of padding: it gives
no group, and launches the same kernels. The JAX package's fixed
buckets, their doubled-cap retries and its "capacity not divisible by
mesh size" and "shuffle overflow persists" bails are gone: the exchange
is sized by its count trade. A heavy group lands whole on one rank, as
an exact median needs.
"""

from __future__ import annotations

import torch

from aquery2_tpu_torch.engine import fused_groupby as fg
from aquery2_tpu_torch.engine import fused_ordered as fo
from aquery2_tpu_torch.ops import ragged
from aquery2_tpu_torch.ops.sort import lexsort
from aquery2_tpu_torch.parallel import comm
from aquery2_tpu_torch.parallel.dist_join import destinations
from aquery2_tpu_torch.parallel.mesh import (LocalView, block_column,
                                             local_view)
from aquery2_tpu_torch.parser import ast_nodes as A


def all_max(mesh):
    """fused_groupby.float_sums_fit's ``reduce`` on a mesh: the ranks'
    elementwise max, so that every rank decides alike."""
    return lambda t: comm.all_reduce(mesh, t, "max")


def key_lanes(session, keys, cols, reason: str):
    """A function of the rows' env giving the lanes that route each row by
    its key, or None with ``reason`` noted (a key over a float column):
    one packed int32 word where every key is an integer column whose
    global stats fit one 30-bit word, else each key expression's
    values."""
    names = [k.name.lower() for k in keys if isinstance(k, A.ColumnRef)]
    if len(names) == len(keys) and all(
            not cols[kn].data.is_floating_point() for kn in names):
        mins, ranges = [], []
        for kn in names:
            mn, mx = cols[kn].stats()
            mins.append(int(mn))
            ranges.append(int(mx) - int(mn) + 1)
        plan_w = fg._plan_words(ranges)
        if plan_w is not None and plan_w[1] == 1:
            fields = plan_w[0]

            def word(env, valid):
                w = torch.zeros(valid.shape, dtype=torch.int32,
                                device=valid.device)
                for ki, kn in enumerate(names):
                    _wi, shift, _b = fields[ki]
                    w |= (env[kn].to(torch.int64) - mins[ki]).to(
                        torch.int32) << shift
                return [w]
            return word
    for k in keys:
        for nm in fg._refs(k):
            if nm in cols and cols[nm].data.is_floating_point():
                session.note_dist_bail(reason)
                return None
    return lambda env, valid: [fg._as_rows(fg._row_eval(k, env), valid)
                               for k in keys]


def shuffle(mesh, local: LocalView, col_order, null_order, route, valid,
            with_gidx: bool = False) -> LocalView:
    """The rows of ``valid`` (with the columns of col_order, the validity
    of those of null_order and, where asked, their global row index) moved
    to the rank their key lanes (``route``) hash to: this rank's received
    rows as a LocalView whose block columns carry the table's global
    stats, in global row order, padded to one row where none came."""
    cols = local.columns
    env = {nm: cols[nm].data for nm in col_order}
    idx = torch.nonzero(valid).squeeze(1)
    keys = [k[idx] for k in route(env, valid)]
    lanes = ([env[nm][idx] for nm in col_order]
             + [cols[nm].valid[idx] for nm in null_order])
    if with_gidx:
        lanes.append(local.gidx[idx])
    got = comm.all_to_all_v(mesh, destinations(mesh, keys), lanes)
    m = int(got[0].shape[0])

    def pad(x):
        return x if m else x.new_zeros(1)

    oks = dict(zip(null_order, got[len(col_order):]))
    blocks = []
    for nm, x in zip(col_order, got):
        c = cols[nm]
        ok = oks.get(nm)
        blocks.append(block_column(c.name, c.sqltype, pad(x),
                                   None if ok is None else pad(ok),
                                   c.dictionary, c))
    dev = got[0].device
    rows = torch.arange(max(m, 1), device=dev)
    gidx = pad(got[-1]) if with_gidx else rows
    return LocalView(local.name, blocks, m, rows < m, gidx)


def _window_over_nullable(e, nullable) -> bool:
    """True if e contains a windowed call referencing a nullable column."""
    if fo._is_window_call(e) and fg._refs(e) & nullable:
        return True
    if isinstance(e, A.BinOp):
        return (_window_over_nullable(e.left, nullable)
                or _window_over_nullable(e.right, nullable))
    if isinstance(e, A.UnaryOp):
        return _window_over_nullable(e.operand, nullable)
    if isinstance(e, A.Call):
        return any(_window_over_nullable(a, nullable) for a in e.args
                   if not isinstance(a, A.Star))
    return False


def _prep(session, table, p):
    """The shared gates and layout: (the rank's view, the referenced
    columns, the nullable ones, the key's route, the rows WHERE keeps),
    or None with the reason noted. NULL-able aggregate arguments ride
    the shuffle with their masks; NULL-able keys, ASSUMING columns,
    WHERE columns, row projections and windowed aggregate arguments stay
    on the gathered path."""
    local = local_view(session.mesh, table)
    if local.n == 0:
        session.note_dist_bail("empty table")
        return None
    cols = local.columns
    col_order = fg.referenced_columns(p)
    nullable = {nm for nm in col_order
                if nm in cols and cols[nm].valid is not None}
    if nullable:
        _n, bail = fg.nullable_gate(p, cols, col_order)
        if bail:
            session.note_dist_bail(bail)
            return None
        for an, _asc in p.get("assume", ()):
            if an in nullable:
                session.note_dist_bail("nullable ASSUMING column")
                return None
        for kindp, expr, _ in p["projections"]:
            if kindp == "row" and fg._refs(expr) & nullable:
                session.note_dist_bail(
                    "nullable column in windowed row projection")
                return None
        # a NULL poisons a running window from its row on: order-dependent
        # NULL propagation stays on the gathered path
        if any(_window_over_nullable(a, nullable)
               for _k, cargs in fg._needed_scatters(p["aggs"]).values()
               for a in cargs if not isinstance(a, A.Star)):
            session.note_dist_bail("nullable column in windowed agg arg")
            return None
    route = key_lanes(session, p["keys"], cols,
                      "non-integer ordered group key")
    if route is None:
        return None
    env = {nm: cols[nm].data for nm in col_order}
    valid = local.valid
    if p["where"] is not None:
        valid = valid & fg._truth(fg._as_rows(fg._row_eval(p["where"], env),
                                              valid))
    return local, col_order, sorted(nullable), route, valid


def _received(recv: LocalView, col_order, null_order):
    """The received rows' env and NULL masks."""
    rc = recv.columns
    return ({nm: rc[nm].data for nm in col_order},
            {nm: ~rc[nm].valid for nm in null_order})


def _key_bounds(keys, cols):
    """Each key's (min, max) from global stats (an integer column key), or
    None (a computed key)."""
    out = []
    for k in keys:
        c = cols[k.name] if isinstance(k, A.ColumnRef) else None
        out.append(None if c is None or c.data.is_floating_point()
                   else tuple(c.stats()))
    return out


def _gather_groups(mesh, keyvals, lanes, bounds):
    """Every rank's disjoint groups, once, on every rank (one
    all_gather_v): (their keys, their lanes, the permutation that orders
    them by key)."""
    nk = len(keyvals)
    got, _sizes = comm.all_gather_v(mesh, list(keyvals) + list(lanes))
    order = lexsort([(k, True) if b is None else (k, True, b)
                     for k, b in zip(got[:nk], bounds)])[0]
    return got[:nk], got[nk:], order


# --------------------------------------------------------------------- #
# the median (h2o q6 class)
# --------------------------------------------------------------------- #

def run_median(session, sel: A.Select, table, p):
    """A grouped query with median(): the rows shuffled so that each
    group lies on one rank, which reduces it with the sort tier (the
    median argument as the secondary sort key: packed words where the
    keys pack, the key values otherwise), then the groups merged and
    finished (HAVING, ORDER BY, LIMIT) on every rank. None with the
    reason noted where a gate declines."""
    got = _prep(session, table, p)
    if got is None:
        return None
    local, col_order, null_order, route, valid = got
    mesh = session.mesh
    cols = local.columns
    scatters = fg._needed_scatters(p["aggs"])
    env = {nm: cols[nm].data for nm in col_order}
    null_fn = (fg.make_null_fn({nm: ~cols[nm].valid for nm in null_order})
               if null_order else None)
    if not fg.float_sums_fit(scatters, cols, local.n,
                             lambda e: fg._row_eval(e, env), valid, null_fn,
                             reduce=all_max(mesh)):
        session.note_dist_bail("float sums outside the exact lanes")
        return None
    session.note_spmd()
    recv = shuffle(mesh, local, col_order, null_order, route, valid)
    renv, rnull = _received(recv, col_order, null_order)
    chosen = fg.choose_strategy(p, recv.columns)
    bounds = _key_bounds(p["keys"], cols)
    if chosen is not None:
        _s, key_mins, key_ranges, _d = chosen
        dense, _counts, keyvals = fg._run_packed(
            renv, rnull, recv.valid, scatters, p["keys"], key_mins,
            key_ranges)
    else:                       # computed keys, or wider than one word
        dense, _counts, keyvals = fg._run_sort(
            renv, rnull, recv.valid, scatters, p["keys"], bounds)
    tags = sorted(dense)
    keys, lanes, order = _gather_groups(mesh, keyvals,
                                        [dense[t] for t in tags], bounds)
    merged = {t: x[order] for t, x in zip(tags, lanes)}
    return fg.finish_groups(p, cols, merged, merged["__counts__"],
                            [k[order] for k in keys])


# --------------------------------------------------------------------- #
# the ordered tier (h2o q8, the trades queries)
# --------------------------------------------------------------------- #

def run_ordered(session, sel: A.Select, table):
    """An ASSUMING or windowed grouped query (fused_ordered's shapes) over
    the mesh: the rows shuffled by group key, fused_ordered.ordered_groups
    on each rank's complete groups, then one merge: each group's scalars
    and kept counts gathered and ordered by key, and each ragged
    projection's values gathered and taken group by group in that order.
    Serves both of the JAX package's output shapes (the bounded subvec
    of h2o q8 and the running aggregates' rows). None with the reason
    noted where a gate declines."""
    try:
        p = fo.plan(sel, table)
    except fg.Unsupported as e:
        session.note_dist_bail(f"unsupported ordered shape: {e}")
        return None
    got = _prep(session, table, p)
    if got is None:
        return None
    local, col_order, null_order, route, valid = got
    mesh = session.mesh
    cols = local.columns
    recv = shuffle(mesh, local, col_order, null_order, route, valid)
    renv, rnull = _received(recv, col_order, null_order)
    parts = fo.ordered_groups(dict(p, where=None), recv.columns, local.n,
                              renv, recv.valid, rnull, reduce=all_max(mesh))
    if parts is None:
        session.note_dist_bail("float sums outside the exact lanes")
        return None
    session.note_spmd()
    keyvals, results = parts
    kinds = [kindp for kindp, _e, _a in p["projections"]]
    merged = [i for i, k in enumerate(kinds) if k != "key"]
    keys, lanes, order = _gather_groups(
        mesh, keyvals, [results[i] if kinds[i] == "agg" else results[i][1]
                        for i in merged], _key_bounds(p["keys"], cols))
    keys = [k[order] for k in keys]
    g = int(order.shape[0])
    key_names = [k.name.lower() for k in p["keys"]]
    out = [None if kindp != "key" else keys[key_names.index(e.name.lower())]
           for kindp, e, _a in p["projections"]]
    for i, lane in zip(merged, lanes):
        if kinds[i] == "agg":
            out[i] = lane[order]
            continue
        # a ragged projection: every rank's values, group after group,
        # taken in key order
        (vals,), _sizes = comm.all_gather_v(mesh, [results[i][0]])
        offsets = torch.cat([lane.new_zeros(1), torch.cumsum(lane, 0)])
        total = int(vals.shape[0])
        out[i] = (ragged.take(vals, offsets, order, g, total, total)[0],
                  lane[order])
    return fo.to_table(p, cols, keys, out)
