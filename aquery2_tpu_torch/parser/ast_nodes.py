"""Typed AST for the AQuery dialect.

Replaces the reference's JSON-dict AST (aquery_parser output consumed by
engine/ast.py) with dataclasses; the planner (plan/binder.py) consumes
these.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any


# --- expressions ----------------------------------------------------------

class Expr:
    __slots__ = ()


@dataclass(frozen=True)
class Literal(Expr):
    value: Any           # int | float | str | bool | None
    is_string: bool = False


@dataclass(frozen=True)
class ColumnRef(Expr):
    name: str
    table: str | None = None  # qualifier, e.g. t.a

    def __str__(self) -> str:
        return f"{self.table}.{self.name}" if self.table else self.name


@dataclass(frozen=True)
class Star(Expr):
    table: str | None = None


@dataclass(frozen=True)
class BinOp(Expr):
    op: str              # '+','-','*','/','%','=','<>','<','>','<=','>=','and','or','like'
    left: Expr
    right: Expr


@dataclass(frozen=True)
class UnaryOp(Expr):
    op: str              # '-', 'not', 'missing' (IS NULL)
    operand: Expr


@dataclass(frozen=True)
class Call(Expr):
    func: str
    args: tuple[Expr, ...]
    distinct: bool = False   # COUNT(DISTINCT x)


@dataclass(frozen=True)
class Index(Expr):
    """x[i] inside UDF bodies."""
    base: Expr
    index: Expr


@dataclass(frozen=True)
class CaseWhen(Expr):
    whens: tuple[tuple[Expr, Expr], ...]
    default: Expr | None


@dataclass(frozen=True)
class FrameBound:
    """One end of a window frame (reference aquery_parser/windows.py:21-41).

    kind: 'unbounded_preceding' | 'preceding' | 'current' | 'following'
          | 'unbounded_following'; offset set for preceding/following."""
    kind: str
    offset: int = 0


@dataclass(frozen=True)
class WindowFrame:
    """ROWS/RANGE frame (reference windows.py:73-87 row_clause)."""
    unit: str                    # 'rows' | 'range'
    start: FrameBound
    end: FrameBound


@dataclass(frozen=True)
class WindowExpr(Expr):
    """fn(args) OVER (PARTITION BY ... ORDER BY ... [frame])
    (reference windows.py:89-96 over_clause)."""
    func: Call
    partition_by: tuple[Expr, ...] = ()
    order_by: tuple["OrderItem", ...] = ()
    frame: WindowFrame | None = None


# --- select ---------------------------------------------------------------

@dataclass(frozen=True)
class Subquery(Expr):
    """Scalar subquery `(SELECT ...)` or the right side of IN (SELECT ...)."""
    select: "Select"


@dataclass
class Projection:
    expr: Expr
    alias: str | None = None


@dataclass
class TableSource:
    name: str
    alias: str | None = None


@dataclass
class JoinSource:
    left: "Source"
    right: "Source"
    kind: str = "inner"  # 'inner' | 'natural' | 'cross' | 'left' | 'right' | 'full'
    on: Expr | None = None
    using: tuple[str, ...] = ()


@dataclass
class SubquerySource:
    """Derived table: FROM (SELECT ...) [alias]."""
    select: "Select"
    alias: str | None = None


Source = TableSource | JoinSource | SubquerySource


@dataclass
class Assumption:
    col: ColumnRef
    ascending: bool = True


@dataclass(frozen=True)
class OrderItem:
    expr: Expr
    ascending: bool = True


@dataclass
class Select:
    projections: list[Projection]
    sources: list[Source] = field(default_factory=list)
    assumptions: list[Assumption] = field(default_factory=list)
    where: Expr | None = None
    group_by: list[Expr] = field(default_factory=list)
    order_by: list[OrderItem] = field(default_factory=list)
    having: Expr | None = None
    limit: int | None = None
    distinct: bool = False
    into_table: str | None = None
    into_outfile: str | None = None
    outfile_sep: str = ","
    unions: list[tuple[str, "Select"]] = field(default_factory=list)  # ('all'|'distinct', sel)


# --- DDL / DML ------------------------------------------------------------

@dataclass
class ColumnDef:
    name: str
    type_name: str


@dataclass
class CreateTable:
    name: str
    columns: list[ColumnDef] = field(default_factory=list)
    as_select: Select | None = None


@dataclass
class DropTable:
    name: str
    if_exists: bool = False


@dataclass
class Insert:
    table: str
    columns: list[str] = field(default_factory=list)
    values: list[list[Expr]] = field(default_factory=list)
    select: Select | None = None


@dataclass
class Delete:
    table: str
    where: Expr | None = None


@dataclass
class Update:
    table: str
    assignments: list[tuple[str, Expr]] = field(default_factory=list)
    where: Expr | None = None


@dataclass
class Load:
    table: str
    path: str
    field_sep: str = ","
    element_sep: str = ";"
    complex: bool = False        # LOAD COMPLEX DATA (vector cells)


@dataclass
class CreateIndex:
    name: str
    table: str
    columns: list[str] = field(default_factory=list)


# --- UDFs (reference engine/ast.py:1551-1812) -----------------------------

class UdfStmt:
    __slots__ = ()


@dataclass
class UdfAssign(UdfStmt):
    target: Expr                 # ColumnRef or Index
    op: str                      # ':=', '+=', '-=', '*=', '/='
    value: Expr


@dataclass
class UdfIf(UdfStmt):
    cond: Expr
    then: list[UdfStmt]
    elifs: list[tuple[Expr, list[UdfStmt]]] = field(default_factory=list)
    orelse: list[UdfStmt] = field(default_factory=list)


@dataclass
class UdfFor(UdfStmt):
    init: list[UdfAssign]
    cond: Expr
    step: list[UdfAssign]
    body: list[UdfStmt]


@dataclass
class UdfExprStmt(UdfStmt):
    expr: Expr                   # bare expression; last one is the return value


@dataclass
class CreateFunction:
    name: str
    params: list[str]
    body: list[UdfStmt]
    is_aggregation: bool = False # AGGREGATION FUNCTION (vector semantics)


# --- modules / triggers / procedures --------------------------------------

@dataclass
class ModuleFunctionSig:
    name: str
    params: list[tuple[str, str]]   # (name, type_name)
    ret_type: str


@dataclass
class LoadModule:
    path: str
    functions: list[ModuleFunctionSig] = field(default_factory=list)


@dataclass
class CreateTrigger:
    name: str
    action: str                     # stored procedure to run
    interval_ms: int | None = None  # interval trigger
    table: str | None = None        # conditional trigger: ON table
    when: str | None = None         # condition procedure name


@dataclass
class DropTrigger:
    name: str


@dataclass
class CacheTable:
    table: str


@dataclass
class PassthroughSQL:
    """<sql> ... </sql> block. The reference forwards the raw text to
    MonetDB (engine/ast.py:1814-1841); here the inner statements are parsed
    and executed by the same engine (we ARE the SQL engine)."""
    text: str


Statement = Any  # union of the dataclasses above
