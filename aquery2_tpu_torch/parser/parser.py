"""Recursive-descent parser for the AQuery dialect.

Grammar coverage mirrors the reference frontend (aquery_parser/parser.py)
— see package docstring. Keywords are contextual: the reference allows
column names like ``max``/``min`` (tests/q4.a creates ticks2(ID, max,
min)), so any identifier not in statement-starting position is a name.
"""

from __future__ import annotations

from aquery2_tpu_torch.parser import ast_nodes as A
from aquery2_tpu_torch.parser.lexer import Lexer, Token


class ParseError(Exception):
    pass


_STMT_STARTERS = {
    "create", "drop", "insert", "delete", "load", "select", "function",
    "aggregation", "cache", "with", "exec", "truncate", "update",
}

_CLAUSE_KEYWORDS = {
    "from", "where", "group", "order", "having", "limit", "into", "assuming",
    "union", "except", "intersect", "on", "when", "natural", "inner", "left",
    "right", "full", "outer", "join", "cross", "fields", "element", "lines",
    "values", "as", "asc", "desc", "by", "terminated", "and", "or", "not",
    "like", "is", "null", "in", "between", "distinct", "exists", "using",
    "over",
}


class Parser:
    def __init__(self, text: str) -> None:
        self.toks: list[Token] = Lexer(text).tokens()
        self.p = 0

    # -- token helpers -----------------------------------------------------

    def peek(self, k: int = 0) -> Token:
        j = min(self.p + k, len(self.toks) - 1)
        return self.toks[j]

    def next(self) -> Token:
        t = self.toks[self.p]
        if t.kind != "eof":
            self.p += 1
        return t

    def at_kw(self, *words: str, k: int = 0) -> bool:
        t = self.peek(k)
        return t.kind == "ident" and t.text.lower() in words

    def at_op(self, *ops: str, k: int = 0) -> bool:
        t = self.peek(k)
        return t.kind == "op" and t.text in ops

    def accept_kw(self, *words: str) -> str | None:
        if self.at_kw(*words):
            return self.next().text.lower()
        return None

    def accept_op(self, *ops: str) -> str | None:
        if self.at_op(*ops):
            return self.next().text
        return None

    def expect_kw(self, *words: str) -> str:
        if not self.at_kw(*words):
            raise self.error(f"expected {'/'.join(words).upper()}")
        return self.next().text.lower()

    def expect_op(self, op: str) -> str:
        if not self.at_op(op):
            raise self.error(f"expected {op!r}")
        return self.next().text

    def expect_ident(self) -> str:
        t = self.peek()
        if t.kind != "ident":
            raise self.error("expected identifier")
        return self.next().text

    def expect_string(self) -> str:
        t = self.peek()
        if t.kind != "string":
            raise self.error("expected string literal")
        return self.next().text

    def error(self, msg: str) -> ParseError:
        t = self.peek()
        return ParseError(f"line {t.line}: {msg}, got {t.kind} {t.text!r}")

    def _skip_semis(self) -> None:
        while self.accept_op(";"):
            pass

    # -- script ------------------------------------------------------------

    def parse_script(self) -> list[A.Statement]:
        out: list[A.Statement] = []
        self._skip_semis()
        while self.peek().kind != "eof":
            out.append(self.parse_statement())
            self._skip_semis()
        return out

    def parse_statement(self) -> A.Statement:
        t = self.peek()
        if t.kind == "sqlblock":
            self.next()
            return A.PassthroughSQL(t.text)
        if t.kind != "ident":
            raise self.error("expected statement")
        kw = t.text.lower()
        if kw == "create":
            return self._create()
        if kw == "drop":
            return self._drop()
        if kw == "insert":
            return self._insert()
        if kw == "delete":
            return self._delete()
        if kw == "update":
            return self._update()
        if kw == "load":
            return self._load()
        if kw == "select":
            return self.parse_select()
        if kw == "function":
            return self._function(False)
        if kw == "aggregation":
            self.next()
            self.expect_kw("function")
            return self._function_body(True)
        if kw == "cache":
            self.next()
            self.accept_kw("table")
            self.accept_kw("from")
            return A.CacheTable(self.expect_ident())
        raise self.error(f"unknown statement {kw!r}")

    # -- DDL ---------------------------------------------------------------

    def _create(self) -> A.Statement:
        self.next()  # create
        what = self.expect_kw("table", "trigger", "index")
        if what == "trigger":
            return self._create_trigger()
        if what == "index":
            name = self.expect_ident()
            self.expect_kw("on")
            tbl = self.expect_ident()
            cols: list[str] = []
            if self.accept_op("("):
                while not self.accept_op(")"):
                    cols.append(self.expect_ident())
                    self.accept_op(",")
            return A.CreateIndex(name, tbl, cols)
        name = self.expect_ident()
        if self.accept_kw("as"):
            sel = self.parse_select()
            return A.CreateTable(name, as_select=sel)
        self.expect_op("(")
        cols = []
        while not self.accept_op(")"):
            cname = self.expect_ident()
            tname = self.expect_ident()
            if self.accept_op("("):  # varchar(10)
                self.next()  # size
                self.expect_op(")")
            cols.append(A.ColumnDef(cname, tname))
            self.accept_op(",")
        return A.CreateTable(name, columns=cols)

    def _create_trigger(self) -> A.CreateTrigger:
        # CREATE TRIGGER t ACTION a INTERVAL n
        # CREATE TRIGGER t ON tbl ACTION a WHEN q       (parser.py:574-590)
        name = self.expect_ident()
        table = None
        if self.accept_kw("on"):
            table = self.expect_ident()
        self.expect_kw("action")
        action = self.expect_ident()
        interval = None
        when = None
        if self.accept_kw("interval"):
            interval = int(self.next().text)
        elif self.accept_kw("when"):
            when = self.expect_ident()
        return A.CreateTrigger(name, action, interval_ms=interval, table=table, when=when)

    def _drop(self) -> A.Statement:
        self.next()
        what = self.expect_kw("table", "trigger", "index")
        if_exists = False
        if self.accept_kw("if"):
            self.expect_kw("exists")
            if_exists = True
        name = self.expect_ident()
        if what == "trigger":
            return A.DropTrigger(name)
        return A.DropTable(name, if_exists=if_exists)

    # -- DML ---------------------------------------------------------------

    def _insert(self) -> A.Insert:
        self.next()
        self.expect_kw("into")
        table = self.expect_ident()
        cols: list[str] = []
        if self.at_op("(") and not self.at_kw("values", k=0):
            # column list only if followed by VALUES/SELECT after close
            save = self.p
            self.next()
            ok = True
            tmp = []
            while not self.accept_op(")"):
                if self.peek().kind != "ident":
                    ok = False
                    break
                tmp.append(self.next().text)
                self.accept_op(",")
            if ok and (self.at_kw("values") or self.at_kw("select")):
                cols = tmp
            else:
                self.p = save
        if self.accept_kw("values"):
            rows: list[list[A.Expr]] = []
            while True:
                self.expect_op("(")
                row: list[A.Expr] = []
                while not self.accept_op(")"):
                    row.append(self.parse_expr())
                    self.accept_op(",")
                rows.append(row)
                if not self.accept_op(","):
                    break
            return A.Insert(table, columns=cols, values=rows)
        if self.at_kw("select"):
            return A.Insert(table, columns=cols, select=self.parse_select())
        raise self.error("expected VALUES or SELECT")

    def _update(self) -> A.Update:
        self.next()
        table = self.expect_ident()
        self.expect_kw("set")
        assigns: list[tuple[str, A.Expr]] = []
        while True:
            col = self.expect_ident()
            self.expect_op("=")
            assigns.append((col, self.parse_expr()))
            if not self.accept_op(","):
                break
        where = None
        if self.accept_kw("where"):
            where = self.parse_expr()
        return A.Update(table, assigns, where)

    def _delete(self) -> A.Delete:
        self.next()
        self.expect_kw("from")
        table = self.expect_ident()
        where = None
        if self.accept_kw("where"):
            where = self.parse_expr()
        return A.Delete(table, where)

    def _load(self) -> A.Statement:
        self.next()
        if self.accept_kw("module"):
            self.expect_kw("from")
            path = self.expect_string()
            self.expect_kw("functions")
            self.expect_op("(")
            sigs: list[A.ModuleFunctionSig] = []
            while not self.accept_op(")"):
                fname = self.expect_ident()
                self.expect_op("(")
                params: list[tuple[str, str]] = []
                while not self.accept_op(")"):
                    pname = self.expect_ident()
                    self.expect_op(":")
                    ptype = self.expect_ident()
                    params.append((pname, ptype))
                    self.accept_op(",")
                self.expect_op("->")
                ret = self.expect_ident()
                sigs.append(A.ModuleFunctionSig(fname, params, ret))
                self.accept_op(",")
            return A.LoadModule(path, sigs)
        is_complex = bool(self.accept_kw("complex"))
        self.expect_kw("data")
        self.expect_kw("infile")
        path = self.expect_string()
        self.expect_kw("into")
        self.expect_kw("table")
        table = self.expect_ident()
        field_sep, element_sep = ",", ";"
        while True:
            if self.accept_kw("fields"):
                self.expect_kw("terminated")
                self.expect_kw("by")
                field_sep = self.expect_string()
            elif self.accept_kw("element"):
                self.expect_kw("terminated")
                self.expect_kw("by")
                element_sep = self.expect_string()
            else:
                break
        return A.Load(table, path, field_sep=field_sep,
                      element_sep=element_sep, complex=is_complex)

    # -- SELECT ------------------------------------------------------------

    def parse_select(self) -> A.Select:
        sel = self._select_core()
        # set operations chain LEFT-associatively: A EXCEPT B EXCEPT C is
        # (A − B) − C (reference except_clause, engine/ast.py:1143-1155)
        while self.at_kw("union", "except", "intersect"):
            op = self.next().text.lower()
            allq = bool(self.accept_kw("all"))
            sub = self._select_core()
            if op == "union":
                kind = "all" if allq else "distinct"
            else:
                kind = op + ("_all" if allq else "")
            sel.unions.append((kind, sub))
        return sel

    def _select_core(self) -> A.Select:
        self.expect_kw("select")
        sel = A.Select(projections=[])
        sel.distinct = bool(self.accept_kw("distinct"))
        while True:
            sel.projections.append(self._projection())
            if not self.accept_op(","):
                break
        self._select_clauses(sel)
        return sel

    def _projection(self) -> A.Projection:
        if self.at_op("*"):
            self.next()
            return A.Projection(A.Star())
        e = self.parse_expr()
        alias = None
        if self.accept_kw("as"):
            alias = self.expect_ident()
        elif (self.peek().kind == "ident"
              and self.peek().text.lower() not in _CLAUSE_KEYWORDS
              and self.peek().text.lower() not in _STMT_STARTERS):
            alias = self.next().text
        return A.Projection(e, alias)

    def _select_clauses(self, sel: A.Select) -> None:
        while True:
            if self.accept_kw("from"):
                sel.sources = self._sources()
                if self.accept_kw("assuming"):
                    sel.assumptions = self._assumptions()
            elif self.accept_kw("assuming"):
                sel.assumptions = self._assumptions()
            elif self.accept_kw("where"):
                sel.where = self.parse_expr()
            elif self.at_kw("group"):
                self.next()
                self.expect_kw("by")
                while True:
                    sel.group_by.append(self.parse_expr())
                    if not self.accept_op(","):
                        break
            elif self.at_kw("order"):
                self.next()
                self.expect_kw("by")
                while True:
                    e = self.parse_expr()
                    asc = True
                    if self.accept_kw("desc"):
                        asc = False
                    else:
                        self.accept_kw("asc")
                    sel.order_by.append(A.OrderItem(e, asc))
                    if not self.accept_op(","):
                        break
            elif self.accept_kw("having"):
                sel.having = self.parse_expr()
            elif self.accept_kw("limit"):
                sel.limit = int(self.next().text)
            elif self.accept_kw("into"):
                if self.accept_kw("outfile"):
                    sel.into_outfile = self.expect_string()
                    if self.accept_kw("fields"):
                        self.expect_kw("terminated")
                        self.expect_kw("by")
                        sel.outfile_sep = self.expect_string()
                else:
                    sel.into_table = self.expect_ident()
            else:
                return

    def _sources(self) -> list[A.Source]:
        sources: list[A.Source] = [self._table_source()]
        while True:
            if self.accept_op(","):
                sources.append(self._table_source())
            elif self.at_kw("natural"):
                self.next()
                self.expect_kw("join")
                right = self._table_source()
                sources[-1] = A.JoinSource(sources[-1], right, kind="natural")
            elif self.at_kw("inner", "join", "cross", "left", "right", "full"):
                kind = self.next().text.lower()
                if kind in ("left", "right", "full"):
                    # LEFT/RIGHT/FULL [OUTER] JOIN (reference
                    # aquery_parser/parser.py:149, keywords.py:262-266)
                    self.accept_kw("outer")
                    self.expect_kw("join")
                elif kind in ("inner", "cross"):
                    self.expect_kw("join")
                right = self._table_source()
                on = None
                using: tuple[str, ...] = ()
                if self.accept_kw("on"):
                    on = self.parse_expr()
                elif self.accept_kw("using"):
                    self.expect_op("(")
                    u = []
                    while not self.accept_op(")"):
                        u.append(self.expect_ident())
                        self.accept_op(",")
                    using = tuple(u)
                sources[-1] = A.JoinSource(
                    sources[-1], right,
                    kind=("cross" if kind == "cross"
                          else kind if kind in ("left", "right", "full")
                          else "inner"),
                    on=on, using=using)
            else:
                return sources

    def _table_source(self) -> A.Source:
        if self.accept_op("("):
            # derived table: FROM (SELECT ...) [alias]
            sub = self.parse_select()
            self.expect_op(")")
            alias = None
            t = self.peek()
            if (t.kind == "ident" and t.text.lower() not in _CLAUSE_KEYWORDS
                    and t.text.lower() not in _STMT_STARTERS):
                alias = self.next().text
            return A.SubquerySource(sub, alias)
        name = self.expect_ident()
        alias = None
        t = self.peek()
        if (t.kind == "ident" and t.text.lower() not in _CLAUSE_KEYWORDS
                and t.text.lower() not in _STMT_STARTERS):
            alias = self.next().text
        return A.TableSource(name, alias)

    def _assumptions(self) -> list[A.Assumption]:
        out: list[A.Assumption] = []
        while True:
            asc = True
            if self.accept_kw("desc"):
                asc = False
            else:
                self.accept_kw("asc")
            col = self._column_ref()
            out.append(A.Assumption(col, asc))
            if not self.accept_op(","):
                return out

    def _column_ref(self) -> A.ColumnRef:
        a = self.expect_ident()
        if self.accept_op("."):
            b = self.expect_ident()
            return A.ColumnRef(b, table=a)
        return A.ColumnRef(a)

    # -- UDFs --------------------------------------------------------------

    def _function(self, is_agg: bool) -> A.CreateFunction:
        self.next()  # FUNCTION
        return self._function_body(is_agg)

    def _function_body(self, is_agg: bool) -> A.CreateFunction:
        name = self.expect_ident()
        self.expect_op("(")
        params: list[str] = []
        while not self.accept_op(")"):
            params.append(self.expect_ident())
            self.accept_op(",")
        self.expect_op("{")
        body = self._udf_block()
        return A.CreateFunction(name, params, body, is_aggregation=is_agg)

    def _udf_block(self) -> list[A.UdfStmt]:
        out: list[A.UdfStmt] = []
        while not self.accept_op("}"):
            out.append(self._udf_stmt())
            while self.accept_op(";"):
                pass
        return out

    def _udf_stmt(self) -> A.UdfStmt:
        if self.at_kw("if"):
            self.next()
            self.expect_op("(")
            cond = self.parse_expr()
            self.expect_op(")")
            then = self._udf_stmt_or_block()
            elifs: list[tuple[A.Expr, list[A.UdfStmt]]] = []
            orelse: list[A.UdfStmt] = []
            while self.at_kw("elif"):
                self.next()
                self.expect_op("(")
                c = self.parse_expr()
                self.expect_op(")")
                elifs.append((c, self._udf_stmt_or_block()))
            if self.accept_kw("else"):
                orelse = self._udf_stmt_or_block()
            return A.UdfIf(cond, then, elifs, orelse)
        if self.at_kw("for"):
            self.next()
            self.expect_op("(")
            init = self._assign_list(";")
            self.expect_op(";")
            cond = self.parse_expr()
            self.expect_op(";")
            step = self._assign_list(")")
            self.expect_op(")")
            body = self._udf_stmt_or_block()
            return A.UdfFor(init, cond, step, body)
        # assignment vs bare expression: lookahead for := / augmented ops
        save = self.p
        target = self._try_assign_target()
        if target is not None:
            op = self.accept_op(":=", "+=", "-=", "*=", "/=")
            if op:
                value = self.parse_expr()
                return A.UdfAssign(target, op, value)
            self.p = save
        return A.UdfExprStmt(self.parse_expr())

    def _try_assign_target(self) -> A.Expr | None:
        if self.peek().kind != "ident":
            return None
        name = self.next().text
        target: A.Expr = A.ColumnRef(name)
        if self.accept_op("["):
            idx = self.parse_expr()
            self.expect_op("]")
            target = A.Index(target, idx)
        return target

    def _assign_list(self, stop_op: str) -> list[A.UdfAssign]:
        out: list[A.UdfAssign] = []
        if self.at_op(stop_op):
            return out
        while True:
            target = self._try_assign_target()
            if target is None:
                raise self.error("expected assignment")
            op = self.accept_op(":=", "+=", "-=", "*=", "/=")
            if not op:
                raise self.error("expected := in assignment")
            out.append(A.UdfAssign(target, op, self.parse_expr()))
            if not self.accept_op(","):
                return out

    def _udf_stmt_or_block(self) -> list[A.UdfStmt]:
        if self.accept_op("{"):
            return self._udf_block()
        s = self._udf_stmt()
        self.accept_op(";")
        return [s]

    # -- expressions -------------------------------------------------------

    def parse_expr(self) -> A.Expr:
        return self._or()

    def _or(self) -> A.Expr:
        e = self._and()
        while self.at_kw("or"):
            self.next()
            e = A.BinOp("or", e, self._and())
        return e

    def _and(self) -> A.Expr:
        e = self._not()
        while self.at_kw("and"):
            self.next()
            e = A.BinOp("and", e, self._not())
        return e

    def _not(self) -> A.Expr:
        if self.at_kw("not"):
            self.next()
            return A.UnaryOp("not", self._not())
        return self._comparison()

    def _comparison(self) -> A.Expr:
        e = self._additive()
        while True:
            if self.at_op("=", "==", "<>", "!=", "<", ">", "<=", ">="):
                op = self.next().text
                op = {"==": "=", "!=": "<>"}.get(op, op)
                e = A.BinOp(op, e, self._additive())
            elif self.at_kw("like"):
                self.next()
                e = A.BinOp("like", e, self._additive())
            elif self.at_kw("is"):
                self.next()
                neg = bool(self.accept_kw("not"))
                self.expect_kw("null")
                e = A.UnaryOp("missing", e)
                if neg:
                    e = A.UnaryOp("not", e)
            elif self.at_kw("between"):
                self.next()
                lo = self._additive()
                self.expect_kw("and")
                hi = self._additive()
                e = A.BinOp("and", A.BinOp(">=", e, lo), A.BinOp("<=", e, hi))
            elif self.at_kw("not"):
                # postfix negations: NOT IN / NOT BETWEEN / NOT LIKE
                self.next()
                if self.at_kw("like"):
                    self.next()
                    e = A.UnaryOp("not",
                                  A.BinOp("like", e, self._additive()))
                elif self.at_kw("between"):
                    self.next()
                    lo = self._additive()
                    self.expect_kw("and")
                    hi = self._additive()
                    e = A.UnaryOp("not", A.BinOp(
                        "and", A.BinOp(">=", e, lo), A.BinOp("<=", e, hi)))
                elif self.at_kw("in"):
                    self.next()
                    self.expect_op("(")
                    if self.at_kw("select"):
                        sub = self.parse_select()
                        self.expect_op(")")
                        e = A.UnaryOp("not",
                                      A.BinOp("in", e, A.Subquery(sub)))
                        continue
                    items = []
                    while not self.accept_op(")"):
                        items.append(self.parse_expr())
                        self.accept_op(",")
                    cond: A.Expr | None = None
                    for it in items:
                        c = A.BinOp("=", e, it)
                        cond = c if cond is None else A.BinOp("or", cond, c)
                    e = A.UnaryOp("not", cond if cond is not None
                                  else A.Literal(False))
                else:
                    raise ParseError(
                        f"line {self.peek().line}: expected IN/BETWEEN/LIKE "
                        "after NOT")
            elif self.at_kw("in"):
                self.next()
                self.expect_op("(")
                if self.at_kw("select"):    # IN (SELECT ...)
                    sub = self.parse_select()
                    self.expect_op(")")
                    e = A.BinOp("in", e, A.Subquery(sub))
                    continue
                items = []
                while not self.accept_op(")"):
                    items.append(self.parse_expr())
                    self.accept_op(",")
                cond: A.Expr | None = None
                for it in items:
                    c = A.BinOp("=", e, it)
                    cond = c if cond is None else A.BinOp("or", cond, c)
                e = cond if cond is not None else A.Literal(False)
            else:
                return e

    def _additive(self) -> A.Expr:
        e = self._multiplicative()
        while self.at_op("+", "-"):
            op = self.next().text
            e = A.BinOp(op, e, self._multiplicative())
        return e

    def _multiplicative(self) -> A.Expr:
        e = self._unary()
        while self.at_op("*", "/", "%"):
            op = self.next().text
            e = A.BinOp(op, e, self._unary())
        return e

    def _unary(self) -> A.Expr:
        if self.at_op("-"):
            self.next()
            return A.UnaryOp("-", self._unary())
        if self.at_op("+"):
            self.next()
            return self._unary()
        return self._postfix()

    def _postfix(self) -> A.Expr:
        e = self._primary()
        while self.at_op("["):
            self.next()
            idx = self.parse_expr()
            self.expect_op("]")
            e = A.Index(e, idx)
        return e

    def _primary(self) -> A.Expr:
        t = self.peek()
        if t.kind == "int":
            self.next()
            return A.Literal(int(t.text))
        if t.kind == "float":
            self.next()
            return A.Literal(float(t.text))
        if t.kind == "string":
            self.next()
            return A.Literal(t.text, is_string=True)
        if self.at_op("("):
            self.next()
            if self.at_kw("select"):        # scalar subquery
                sub = self.parse_select()
                self.expect_op(")")
                return A.Subquery(sub)
            e = self.parse_expr()
            self.expect_op(")")
            return e
        if self.at_kw("exists"):
            self.next()
            self.expect_op("(")
            sub = self.parse_select()
            self.expect_op(")")
            return A.UnaryOp("exists", A.Subquery(sub))
        if self.at_op("*"):
            self.next()
            return A.Star()
        if t.kind == "ident":
            low = t.text.lower()
            if low == "null":
                self.next()
                return A.Literal(None)
            if low in ("true", "false"):
                self.next()
                return A.Literal(low == "true")
            if low == "case":
                return self._case()
            if low == "not":
                self.next()
                return A.UnaryOp("not", self._not())
            if low in ("distinct",) or low in _STMT_STARTERS:
                raise self.error("expected expression")
            name = self.next().text
            # qualified: t.a  or  t.*
            if self.at_op("."):
                self.next()
                if self.at_op("*"):
                    self.next()
                    return A.Star(table=name)
                col = self.expect_ident()
                if self.at_op("("):  # slicing call on qualified name? rare
                    pass
                return A.ColumnRef(col, table=name)
            if self.at_op("("):
                self.next()
                distinct = bool(self.accept_kw("distinct"))
                args: list[A.Expr] = []
                while not self.accept_op(")"):
                    args.append(self.parse_expr())
                    self.accept_op(",")
                call = A.Call(name.lower(), tuple(args), distinct=distinct)
                if self.at_kw("over"):
                    return self._over_clause(call)
                return call
            return A.ColumnRef(name)
        raise self.error("expected expression")

    def _over_clause(self, call: A.Call) -> A.WindowExpr:
        """OVER (PARTITION BY ... ORDER BY ... [ROWS|RANGE frame])
        (reference aquery_parser/windows.py:89-96)."""
        self.expect_kw("over")
        self.expect_op("(")
        partition: list[A.Expr] = []
        order: list[A.OrderItem] = []
        frame = None
        if self.accept_kw("partition"):
            self.expect_kw("by")
            while True:
                partition.append(self.parse_expr())
                if not self.accept_op(","):
                    break
        if self.accept_kw("order"):
            self.expect_kw("by")
            while True:
                e = self.parse_expr()
                asc = True
                if self.accept_kw("desc"):
                    asc = False
                else:
                    self.accept_kw("asc")
                order.append(A.OrderItem(e, asc))
                if not self.accept_op(","):
                    break
        unit = self.accept_kw("rows", "range")
        if unit:
            if self.accept_kw("between"):
                start = self._frame_bound()
                self.expect_kw("and")
                end = self._frame_bound()
            else:
                start = self._frame_bound()
                end = A.FrameBound("current")
            frame = A.WindowFrame(unit, start, end)
        self.expect_op(")")
        return A.WindowExpr(call, tuple(partition), tuple(order), frame)

    def _frame_bound(self) -> A.FrameBound:
        """UNBOUNDED PRECEDING | n PRECEDING | CURRENT ROW | n FOLLOWING |
        UNBOUNDED FOLLOWING (reference windows.py:21-41)."""
        if self.accept_kw("current"):
            self.expect_kw("row")
            return A.FrameBound("current")
        if self.accept_kw("unbounded"):
            d = self.expect_kw("preceding", "following")
            return A.FrameBound("unbounded_" + d)
        t = self.peek()
        if t.kind != "int":
            raise self.error("expected UNBOUNDED/CURRENT ROW/<n> in frame bound")
        n = int(self.next().text)
        d = self.expect_kw("preceding", "following")
        return A.FrameBound(d, n)

    def _case(self) -> A.Expr:
        self.next()  # case
        whens: list[tuple[A.Expr, A.Expr]] = []
        default: A.Expr | None = None
        while self.at_kw("when"):
            self.next()
            c = self.parse_expr()
            self.expect_kw("then")
            v = self.parse_expr()
            whens.append((c, v))
        if self.accept_kw("else"):
            default = self.parse_expr()
        self.expect_kw("end")
        return A.CaseWhen(tuple(whens), default)
