"""Algebraic rewrite of accumulation-loop AGGREGATION FUNCTIONs.

Counterpart of ``aquery2_tpu/engine/udf_rewrite.py``. The reference
compiles FUNCTION bodies to C++ lambdas whose loops the compiler
vectorizes (engine/ast.py:1551-1812). Here the loop goes away: a body of
the shape

    sx := 0.; sy := 0.; sxy := 0.;
    l := _builtin_len;
    for (i := 0; i < l; i += 1) { sx += x[i]; sy += y[i]; sxy += x[i]*y[i]; }
    (sxy - sx * sy / l) / l

is the post-aggregate expression

    (sum(x*y) - sum(x) * sum(y) / count(*)) / count(*)

and the CALL SITE is rewritten into it before any tier sees the query
(executor.Executor._select), so the fused group-by (on the card the
onehot_segment_sums or seg_cumsum_i64 kernels), the general engine,
HAVING and ungrouped aggregation run it as they run built-in aggregates.

Rewrite conditions (anything else returns None, and the call reaches
engine/udf.run_aggregation_udf, which runs the body on the device,
engine/udf_device.py):
  * an AGGREGATION FUNCTION returning a scalar (no ``_builtin_ret``
    writes);
  * statements are scalar assignments, at most one accumulation FOR
    loop and a final bare return expression, with no IF;
  * the loop is ``for (i := 0; i < LEN; i += 1)`` over the whole group
    (LEN must rewrite to count(*)), and each body statement accumulates
    ``acc += rowexpr`` / ``acc -= rowexpr`` / ``acc := acc ± rowexpr``
    where rowexpr reads group vectors only as ``param[i]`` and reads no
    accumulator;
  * reducer calls sum/avg/count/min/max/first/last over (elementwise
    expressions of) vector params map to the SQL aggregates;
  * every column an argument reads is a plain non-nullable numeric column
    of a FROM table (SQL aggregates skip NULLs; the loop visits every
    row).

Exactness: integer lanes sum in int64, so for integer inputs the
rewritten result equals the sequential float64 loop up to 2^53. As with
the reference's vectorized loop, the order of summation is not the
source order.
"""

from __future__ import annotations

import dataclasses

from aquery2_tpu_torch.parser import ast_nodes as A
from aquery2_tpu_torch.storage.table import nullable

# reducers over group vectors → SQL aggregate of the elementwise arg
_REDUCER_AGGS = {"sum", "avg", "mean", "count", "min", "max",
                 "first", "last"}
# scalar math that may appear anywhere (engine _MATH + general eval)
_MATH_FNS = {"sqrt", "pow", "abs", "exp", "log", "floor", "ceil",
             "round", "sign"}
_ARITH = {"+", "-", "*", "/", "%"}
_CMP = {"=", "<>", "<", ">", "<=", ">="}

_COUNT_STAR = A.Call("count", (A.Star(),))
_ZERO_LITS = (0, 0.0)


class _NoRewrite(Exception):
    pass


def _is_zero(e: A.Expr) -> bool:
    return isinstance(e, A.Literal) and not e.is_string \
        and e.value in _ZERO_LITS


def _contains_agg(e: A.Expr) -> bool:
    if isinstance(e, A.Call):
        if e.func in _REDUCER_AGGS or e == _COUNT_STAR:
            return True
        return any(_contains_agg(a) for a in e.args
                   if not isinstance(a, A.Star))
    if isinstance(e, A.BinOp):
        return _contains_agg(e.left) or _contains_agg(e.right)
    if isinstance(e, A.UnaryOp):
        return _contains_agg(e.operand)
    return False


class _Rewriter:
    """One UDF call site → outer-query aggregate expression."""

    def __init__(self, udf, call: A.Call, udfs: dict):
        self.udf = udf
        self.udfs = udfs
        if len(call.args) != len(udf.params):
            raise _NoRewrite("arity")
        self.args = dict(zip(udf.params, call.args))
        # scalar environment: UDF variable → outer-context expression
        self.env: dict[str, A.Expr] = {}

    # -- body ------------------------------------------------------------

    def run(self) -> A.Expr:
        ret: A.Expr | None = None
        for s in self.udf.body:
            if isinstance(s, A.UdfAssign):
                self._assign(s)
            elif isinstance(s, A.UdfFor):
                self._for(s)
            elif isinstance(s, A.UdfExprStmt):
                ret = self._scalar(s.expr)
            else:                     # UdfIf and friends
                raise _NoRewrite("control flow")
        if ret is None:
            raise _NoRewrite("no return expression")
        return ret

    def _assign(self, s: A.UdfAssign) -> None:
        if not isinstance(s.target, A.ColumnRef):
            raise _NoRewrite("indexed write (_builtin_ret)")
        name = s.target.name
        val = self._scalar(s.value)
        if s.op != ":=":
            cur = self.env.get(name)
            if cur is None:
                raise _NoRewrite("augmented assign to unbound")
            op = {"+=": "+", "-=": "-", "*=": "*", "/=": "/"}[s.op]
            val = A.BinOp(op, cur, val)
        self.env[name] = val

    # -- the accumulation loop --------------------------------------------

    def _for(self, s: A.UdfFor) -> None:
        if len(s.init) != 1 or len(s.step) != 1:
            raise _NoRewrite("loop shape")
        init, step = s.init[0], s.step[0]
        if not (isinstance(init.target, A.ColumnRef) and init.op == ":="
                and _is_zero(init.value)):
            raise _NoRewrite("loop init")
        ivar = init.target.name
        ok_step = (
            isinstance(step.target, A.ColumnRef)
            and step.target.name == ivar
            and ((step.op == "+=" and _is_one(step.value))
                 or (step.op == ":=" and isinstance(step.value, A.BinOp)
                     and step.value.op == "+"
                     and isinstance(step.value.left, A.ColumnRef)
                     and step.value.left.name == ivar
                     and _is_one(step.value.right))))
        if not ok_step:
            raise _NoRewrite("loop step")
        # bound must be the whole group: `i < LEN` with LEN ≡ count(*)
        c = s.cond
        if not (isinstance(c, A.BinOp) and c.op == "<"
                and isinstance(c.left, A.ColumnRef)
                and c.left.name == ivar):
            raise _NoRewrite("loop condition")
        bound = self._scalar(c.right)
        if bound != _COUNT_STAR:
            raise _NoRewrite("loop does not cover the group")

        # accumulations: acc ±= rowexpr (accs may not feed rowexprs)
        accs: set[str] = set()
        updates: list[tuple[str, bool, A.Expr]] = []   # (acc, neg, rowexpr)
        for st in s.body:
            if not (isinstance(st, A.UdfAssign)
                    and isinstance(st.target, A.ColumnRef)):
                raise _NoRewrite("loop body statement")
            acc = st.target.name
            if acc not in self.env:
                raise _NoRewrite("accumulator unbound before loop")
            if st.op in ("+=", "-="):
                neg, val = st.op == "-=", st.value
            elif st.op == ":=" and isinstance(st.value, A.BinOp) \
                    and st.value.op in ("+", "-") \
                    and isinstance(st.value.left, A.ColumnRef) \
                    and st.value.left.name == acc:
                neg, val = st.value.op == "-", st.value.right
            else:
                raise _NoRewrite("non-accumulation loop statement")
            accs.add(acc)
            updates.append((acc, neg, val))
        if not updates:
            raise _NoRewrite("empty loop")
        for acc, neg, val in updates:
            row = self._rowexpr(val, ivar, accs)
            summed = A.Call("sum", (row,))
            cur = self.env[acc]
            if _is_zero(cur):
                self.env[acc] = A.UnaryOp("-", summed) if neg else summed
            else:
                self.env[acc] = A.BinOp("-" if neg else "+", cur, summed)
        # after the loop the counter equals the bound
        self.env[ivar] = bound

    # -- expression contexts ------------------------------------------------

    def _scalar(self, e: A.Expr) -> A.Expr:
        """UDF scalar expression → outer post-aggregate expression."""
        if isinstance(e, A.Literal):
            if e.value is None:
                raise _NoRewrite("null literal")
            return e
        if isinstance(e, A.ColumnRef):
            name = e.name
            if name in self.env:
                return self.env[name]
            if name.lower() == "_builtin_len":
                return _COUNT_STAR
            if name in self.args:
                # a param used as a scalar: only literal bindings are
                # scalars for sure at rewrite time
                a = self.args[name]
                if isinstance(a, A.Literal) and not a.is_string:
                    return a
                if isinstance(a, A.UnaryOp) and a.op == "-" \
                        and isinstance(a.operand, A.Literal):
                    return a
            raise _NoRewrite(f"unbound scalar {name}")
        if isinstance(e, A.BinOp) and e.op in (_ARITH | _CMP
                                               | {"and", "or"}):
            return A.BinOp(e.op, self._scalar(e.left), self._scalar(e.right))
        if isinstance(e, A.UnaryOp) and e.op in ("-", "not"):
            return A.UnaryOp(e.op, self._scalar(e.operand))
        if isinstance(e, A.Call):
            if e.func in _REDUCER_AGGS:
                if len(e.args) != 1:
                    raise _NoRewrite("reducer arity")
                row = self._vecexpr(e.args[0])
                return A.Call(e.func, (row,))
            if e.func in _MATH_FNS:
                return A.Call(e.func,
                              tuple(self._scalar(a) for a in e.args))
            inner = self.udfs.get(e.func.lower())
            if inner is not None and getattr(inner, "is_aggregation", False):
                raise _NoRewrite("nested aggregation UDF")
        raise _NoRewrite(f"scalar expr {type(e).__name__}")

    def _vecexpr(self, e: A.Expr) -> A.Expr:
        """Elementwise UDF vector expression (no [i]) → outer row expr."""
        if isinstance(e, A.Literal):
            if e.value is None or e.is_string:
                raise _NoRewrite("literal in vector expr")
            return e
        if isinstance(e, A.ColumnRef):
            if e.name in self.args:
                return self.args[e.name]
            raise _NoRewrite(f"vector ref {e.name}")
        if isinstance(e, A.BinOp) and e.op in _ARITH | _CMP:
            return A.BinOp(e.op, self._vecexpr(e.left),
                           self._vecexpr(e.right))
        if isinstance(e, A.UnaryOp) and e.op == "-":
            return A.UnaryOp("-", self._vecexpr(e.operand))
        if isinstance(e, A.Call) and e.func in _MATH_FNS:
            return A.Call(e.func, tuple(self._vecexpr(a) for a in e.args))
        raise _NoRewrite(f"vector expr {type(e).__name__}")

    def _rowexpr(self, e: A.Expr, ivar: str, accs: set[str]) -> A.Expr:
        """Loop-body addend → outer row expression: `param[i]` becomes
        the call-site argument, loop-invariant AGGREGATE-FREE scalars
        substitute inline, accumulators and the loop counter may not
        appear outside an index."""
        if isinstance(e, A.Literal):
            if e.value is None:
                raise _NoRewrite("null literal")
            return e
        if isinstance(e, A.Index):
            if not (isinstance(e.base, A.ColumnRef)
                    and e.base.name in self.args
                    and isinstance(e.index, A.ColumnRef)
                    and e.index.name == ivar):
                raise _NoRewrite("indexed access beyond param[i]")
            return self.args[e.base.name]
        if isinstance(e, A.ColumnRef):
            name = e.name
            if name in accs or name == ivar:
                raise _NoRewrite("loop-carried dependence")
            if name in self.env:
                sub = self.env[name]
                if _contains_agg(sub):
                    # a per-group value inside a row expression would be
                    # a nested aggregate — not a plain sum lane
                    raise _NoRewrite("group scalar inside loop body")
                return sub
            if name in self.args:
                a = self.args[name]
                if isinstance(a, A.Literal) and not a.is_string:
                    return a
            raise _NoRewrite(f"loop-body ref {name}")
        if isinstance(e, A.BinOp) and e.op in _ARITH | _CMP:
            return A.BinOp(e.op, self._rowexpr(e.left, ivar, accs),
                           self._rowexpr(e.right, ivar, accs))
        if isinstance(e, A.UnaryOp) and e.op == "-":
            return A.UnaryOp("-", self._rowexpr(e.operand, ivar, accs))
        if isinstance(e, A.Call) and e.func in _MATH_FNS:
            return A.Call(e.func, tuple(self._rowexpr(a, ivar, accs)
                                        for a in e.args))
        raise _NoRewrite(f"loop-body expr {type(e).__name__}")


def _is_one(e: A.Expr) -> bool:
    return isinstance(e, A.Literal) and not e.is_string and e.value == 1


def rewrite_call(udf, call: A.Call, udfs: dict) -> A.Expr | None:
    """Rewrite one aggregation-UDF call into a post-aggregate expression,
    or None if the body is not an accumulation pattern."""
    if not getattr(udf, "is_aggregation", False):
        return None
    try:
        out = _Rewriter(udf, call, udfs).run()
    except _NoRewrite:
        return None
    except RecursionError:
        return None
    if not _contains_agg(out):
        return None                     # degenerate: not an aggregation
    return out


# --------------------------------------------------------------------- #
# SELECT-level integration
# --------------------------------------------------------------------- #

def _refs_of(e: A.Expr, out: set[str]) -> None:
    if isinstance(e, A.ColumnRef):
        out.add(e.name.lower())
    elif isinstance(e, A.BinOp):
        _refs_of(e.left, out)
        _refs_of(e.right, out)
    elif isinstance(e, A.UnaryOp):
        _refs_of(e.operand, out)
    elif isinstance(e, A.Call):
        for a in e.args:
            if not isinstance(a, A.Star):
                _refs_of(a, out)


def _args_rewritable(call: A.Call, tables) -> bool:
    """Every column a FUNCTION argument references must resolve to a
    plain non-nullable numeric column of a FROM table (a Column without
    validity, not a VectorColumn): SQL aggregates skip NULL rows while
    the loop visits every group row, so a nullable input keeps the loop's
    semantics (engine/udf_device.py runs it)."""
    refs: set[str] = set()
    for a in call.args:
        if isinstance(a, A.Star):
            return False
        _refs_of(a, refs)
    for r in refs:
        hits = [t.columns[r] for t in tables if r in t.columns]
        if len(hits) != 1:
            return False
        c = hits[0]
        if c.is_vector or c.sqltype.is_string or nullable(c):
            return False
    return True


def _rewrite_expr(e: A.Expr, session, tables) -> A.Expr:
    """Replace rewritable aggregation-UDF calls throughout an expression."""
    if isinstance(e, A.Call):
        udf = session.udfs.get(e.func.lower())
        if udf is not None and getattr(udf, "is_aggregation", False) \
                and not e.distinct and _args_rewritable(e, tables):
            new = rewrite_call(udf, e, session.udfs)
            if new is not None:
                return new
        return A.Call(e.func,
                      tuple(a if isinstance(a, A.Star)
                            else _rewrite_expr(a, session, tables)
                            for a in e.args), e.distinct)
    if isinstance(e, A.BinOp):
        return A.BinOp(e.op, _rewrite_expr(e.left, session, tables),
                       _rewrite_expr(e.right, session, tables))
    if isinstance(e, A.UnaryOp):
        return A.UnaryOp(e.op, _rewrite_expr(e.operand, session, tables))
    return e


def rewrite_select(session, sel) -> "A.Select | None":
    """Return a new Select with accumulation-pattern aggregation-UDF
    calls replaced by algebraically-equal aggregate expressions, or
    None when nothing rewrites. Only projections and HAVING are
    rewritten (aggregates cannot appear in WHERE)."""
    if not session.udfs:
        return None
    names = set(session.udfs)

    def mentions(e: A.Expr) -> bool:
        if isinstance(e, A.Call):
            return e.func.lower() in names or any(
                mentions(a) for a in e.args if not isinstance(a, A.Star))
        if isinstance(e, A.BinOp):
            return mentions(e.left) or mentions(e.right)
        if isinstance(e, A.UnaryOp):
            return mentions(e.operand)
        return False

    touched = any(not isinstance(p.expr, A.Star) and mentions(p.expr)
                  for p in sel.projections)
    if sel.having is not None:
        touched = touched or mentions(sel.having)
    if not touched:
        return None

    tables = []
    for src in sel.sources:
        if isinstance(src, A.TableSource) and src.name in session.catalog:
            tables.append(session.catalog.get(src.name))
        else:
            return None          # joins/subqueries: resolve conservatively

    changed = False
    new_projs = []
    for p in sel.projections:
        if isinstance(p.expr, A.Star):
            new_projs.append(p)
            continue
        ne = _rewrite_expr(p.expr, session, tables)
        if ne != p.expr:
            changed = True
            # keep the UDF call's derived output name stable for users
            alias = p.alias
            if alias is None and isinstance(p.expr, A.Call) \
                    and p.expr.func.lower() in names:
                from aquery2_tpu_torch.engine.fused_groupby import \
                    derive_name
                alias = derive_name(p.expr)
            new_projs.append(A.Projection(ne, alias))
        else:
            new_projs.append(p)
    new_having = sel.having
    if sel.having is not None:
        nh = _rewrite_expr(sel.having, session, tables)
        if nh != sel.having:
            changed = True
            new_having = nh
    if not changed:
        return None
    session.stats.note_udf("rewritten")
    return dataclasses.replace(sel, projections=list(new_projs),
                               having=new_having)
