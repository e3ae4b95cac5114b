"""User FUNCTIONs: scalar FUNCTIONs and AGGREGATION FUNCTIONs.

Counterpart of ``aquery2_tpu/engine/udf.py``. A FUNCTION body is a list
of ``:=`` assignments whose last bare expression is the value returned;
an AGGREGATION FUNCTION also sees ``_builtin_len`` (the group's size) and
``_builtin_ret`` (an output vector) and may use if/elif/else, for loops,
element reads x[i] and slices x(a, b).

* A scalar FUNCTION is inlined into the evaluator: each assignment binds
  a local (EvalContext.env) that later expressions read, so
  ``f(price, quantity)`` runs as the tensor ops of its body on the
  session's device.
* A scalar FUNCTION whose arguments are all scalars, or whose body has
  if/for, runs in ``_HostEval``, a numpy interpreter, as the JAX package
  runs it on the host by design.
* An AGGREGATION FUNCTION call that engine/udf_rewrite.py rewrote into
  aggregates never reaches this module. Any other call runs its body on
  the device, batched over the groups (engine/udf_device.py: if/elif/else
  and for loops under per-group masks, over power-of-two length classes
  of the padded group matrix). Only a body the device path cannot run
  (its ``_Untraceable``: an unbound name, a NULL literal in an
  expression, an unknown call, a loop that mutates nothing, a rank
  change) runs in ``_HostEval`` once per group, as in the JAX package.
  Every call notes its route in ``session.stats`` (runtime/stats.py).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from aquery2_tpu_torch import types as T
from aquery2_tpu_torch.parser import ast_nodes as A

class UdfError(Exception):
    pass


class Udf:
    def __init__(self, stmt: A.CreateFunction) -> None:
        self.name = stmt.name.lower()
        self.params = stmt.params
        self.body = stmt.body
        self.is_aggregation = stmt.is_aggregation

    def __repr__(self) -> str:
        kind = "AGGREGATION FUNCTION" if self.is_aggregation else "FUNCTION"
        return f"<{kind} {self.name}({', '.join(self.params)})>"


def _has_control_flow(body) -> bool:
    return any(isinstance(s, (A.UdfIf, A.UdfFor)) for s in body)


def run_scalar_udf(ctx, udf: Udf, args: list):
    """A scalar FUNCTION's value: inlined into the evaluator, or through
    the host interpreter for all-scalar arguments or if/for bodies."""
    if all(v.kind == "scalar" for v in args) or _has_control_flow(udf.body):
        _note(ctx, "scalar_host")
        np_args = [_to_host(ctx, v) for v in args]
        res = _HostEval(ctx, dict(zip(udf.params, np_args))).run(udf.body)
        return _from_host(ctx, res)

    _note(ctx, "scalar_device")
    frame = dict(zip(udf.params, args))
    ctx.env.append(frame)
    try:
        result = None
        for stmt in udf.body:
            if isinstance(stmt, A.UdfAssign):
                if not isinstance(stmt.target, A.ColumnRef):
                    raise UdfError("indexed assignment needs an AGGREGATION "
                                   "FUNCTION")
                name = stmt.target.name
                if stmt.op == ":=":
                    frame[name] = ctx.eval(stmt.value)
                    continue
                if name not in frame:
                    raise UdfError(f"augmented assign to unbound {name}")
                op = {"+=": "+", "-=": "-", "*=": "*", "/=": "/"}[stmt.op]
                frame[name] = ctx.eval(A.BinOp(op, A.ColumnRef(name),
                                               stmt.value))
            elif isinstance(stmt, A.UdfExprStmt):
                result = ctx.eval(stmt.expr)
            else:
                raise UdfError("control flow in a vector scalar FUNCTION")
        if result is None:
            raise UdfError(f"FUNCTION {udf.name} has no return expression")
        return result
    finally:
        ctx.env.pop()


def _note(ctx, route: str) -> None:
    if ctx.session is not None:
        ctx.session.stats.note_udf(route)


def run_aggregation_udf(ctx, udf: Udf, args: list):
    """An AGGREGATION FUNCTION call that engine/udf_rewrite.py did not
    rewrite: the batched device body (engine/udf_device.py), or, where
    that declines the body's shape (it returns None), the host
    interpreter once per group. Nothing else is caught: an error of the
    device path propagates."""
    from aquery2_tpu_torch.engine import udf_device
    from aquery2_tpu_torch.engine.eval import Value

    dv = udf_device.try_run_aggregation_udf(ctx, udf, args)
    if dv is not None:
        _note(ctx, "traced")
        return dv

    _note(ctx, "interpreted")
    offsets = ctx.np_offsets()
    np_args = [_to_host(ctx, v) for v in args]
    rets: list[np.ndarray] = []
    scalars: list[Any] = []
    returns_vector = False
    for g in range(ctx.G):
        lo, hi = int(offsets[g]), int(offsets[g + 1])
        env: dict[str, Any] = {}
        for p, a in zip(udf.params, np_args):
            env[p] = a[lo:hi] if isinstance(a, np.ndarray) else a
        env["_builtin_len"] = hi - lo
        env["_builtin_ret"] = np.zeros(hi - lo, dtype=np.float64)
        h = _HostEval(ctx, env)
        res = h.run(udf.body)
        if res is None or h.ret_written:
            returns_vector = True
            rets.append(env["_builtin_ret"])
        else:
            scalars.append(res)

    dev = ctx.ws.device
    if returns_vector:
        flat = np.concatenate(rets) if rets else np.zeros(0)
        out = np.zeros(ctx.ws.capacity, dtype=np.float64)
        out[:len(flat)] = flat
        return Value("row", torch.from_numpy(out).to(dev), T.DoubleT)
    arr = np.zeros(ctx.gcap, dtype=np.float64)
    arr[:ctx.G] = np.asarray(scalars, dtype=np.float64)
    return Value("group", torch.from_numpy(arr).to(dev), T.DoubleT)


def _to_host(ctx, v) -> Any:
    if v.kind == "scalar":
        return v.data
    return ctx.to_row(v).data.cpu().numpy()


def _from_host(ctx, res):
    from aquery2_tpu_torch.engine.eval import Value

    if isinstance(res, np.ndarray):
        return Value("row", torch.from_numpy(res).to(ctx.ws.device),
                     T.from_np_dtype(res.dtype))
    if isinstance(res, (bool, np.bool_)):
        return Value("scalar", bool(res), T.BoolT)
    if isinstance(res, (int, np.integer)):
        return Value("scalar", int(res), T.LongT)
    if res is None:
        return Value("scalar", None, T.DoubleT)
    return Value("scalar", float(res), T.DoubleT)


# --- the host interpreter ---------------------------------------------------

class _HostEval:
    """numpy interpreter of FUNCTION bodies (the reference's generated C++
    lambdas, engine/ast.py:1610-1801)."""

    def __init__(self, ctx, env: dict[str, Any]) -> None:
        self.ctx = ctx          # for nested FUNCTION calls
        self.env = env
        self.ret_written = False

    def run(self, body) -> Any:
        """The value of the body's last bare expression."""
        last = None
        for stmt in body:
            last = self.stmt(stmt)
        return last

    def stmt(self, s) -> Any:
        if isinstance(s, A.UdfAssign):
            self.assign(s)
            return None
        if isinstance(s, A.UdfExprStmt):
            if isinstance(s.expr, A.Literal) and s.expr.value is None:
                return None             # `Null`: return _builtin_ret
            if isinstance(s.expr, A.ColumnRef) \
                    and s.expr.name.lower() == "null":
                return None
            return self.expr(s.expr)
        if isinstance(s, A.UdfIf):
            if self.expr(s.cond):
                return self.run(s.then)
            for c, blk in s.elifs:
                if self.expr(c):
                    return self.run(blk)
            return self.run(s.orelse)
        if isinstance(s, A.UdfFor):
            for a in s.init:
                self.assign(a)
            guard = 0
            while self.expr(s.cond):
                self.run(s.body)
                for a in s.step:
                    self.assign(a)
                guard += 1
                if guard > 100_000_000:
                    raise UdfError("runaway FUNCTION loop")
            return None
        raise UdfError(f"unknown FUNCTION statement {s}")

    def assign(self, s: A.UdfAssign) -> None:
        val = self.expr(s.value)
        if isinstance(s.target, A.ColumnRef):
            name = s.target.name
            if s.op == ":=":
                self.env[name] = val
            else:
                self.env[name] = _AUG[s.op](self.env[name], val)
        elif isinstance(s.target, A.Index) \
                and isinstance(s.target.base, A.ColumnRef):
            base = s.target.base
            arr = self.env[base.name]
            idx = int(self.expr(s.target.index))
            if base.name == "_builtin_ret":
                self.ret_written = True
            if s.op == ":=":
                arr[idx] = val
            else:
                arr[idx] = _AUG[s.op](arr[idx], val)
        else:
            raise UdfError("bad assignment target")

    def expr(self, e) -> Any:
        if isinstance(e, A.Literal):
            return e.value
        if isinstance(e, A.ColumnRef):
            if e.name in self.env:
                return self.env[e.name]
            low = e.name.lower()
            if low in self.env:
                return self.env[low]
            if low == "null":
                return None
            raise UdfError(f"unbound variable {e.name} in FUNCTION")
        if isinstance(e, A.Index):
            return self.expr(e.base)[int(self.expr(e.index))]
        if isinstance(e, A.UnaryOp):
            v = self.expr(e.operand)
            if e.op == "-":
                return -v
            if e.op == "not":
                return ~v if isinstance(v, np.ndarray) else (not v)
            raise UdfError(f"unary {e.op} in FUNCTION")
        if isinstance(e, A.BinOp):
            return _BIN[e.op](self.expr(e.left), self.expr(e.right))
        if isinstance(e, A.Call):
            return self.call(e)
        raise UdfError(f"cannot interpret {e}")

    def call(self, e: A.Call) -> Any:
        name = e.func
        # x(a, b) of a bound vector: the slice [a, b)
        if name in self.env and isinstance(self.env[name], np.ndarray) \
                and len(e.args) == 2:
            a = int(self.expr(e.args[0]))
            b = int(self.expr(e.args[1]))
            return self.env[name][a:b]
        args = [self.expr(a) for a in e.args]
        if name in _HOST_FNS:
            return _HOST_FNS[name](*args)
        sess = getattr(self.ctx, "session", None)
        if sess is not None and name in sess.udfs:
            sub = sess.udfs[name]
            return _HostEval(self.ctx, dict(zip(sub.params, args))).run(
                sub.body)
        raise UdfError(f"unknown function {name} in FUNCTION body")


_AUG = {
    "+=": lambda a, b: a + b,
    "-=": lambda a, b: a - b,
    "*=": lambda a, b: a * b,
    "/=": lambda a, b: a / b,
}

_BIN = {
    "+": lambda a, b: a + b,
    "-": lambda a, b: a - b,
    "*": lambda a, b: a * b,
    "/": lambda a, b: a / b,
    "%": lambda a, b: a % b,
    "=": lambda a, b: a == b,
    "<>": lambda a, b: a != b,
    "<": lambda a, b: a < b,
    ">": lambda a, b: a > b,
    "<=": lambda a, b: a <= b,
    ">=": lambda a, b: a >= b,
    "and": lambda a, b: np.logical_and(a, b),
    "or": lambda a, b: np.logical_or(a, b),
}


def _h_sums(x):
    x = np.asarray(x)
    return np.cumsum(x.astype(np.float64 if x.dtype.kind == "f"
                              else np.int64))


def _h_avgs(*args):
    if len(args) == 2:
        w, x = int(args[0]), np.asarray(args[1])
        out = np.empty(len(x), np.float64)
        for i in range(len(x)):
            out[i] = x[max(0, i - w + 1): i + 1].mean()
        return out
    x = np.asarray(args[0])
    return _h_sums(x) / np.arange(1, len(x) + 1)


def _h_avg(x):
    x = np.asarray(x, dtype=np.float64)
    return x.mean() if x.size else 0.0


_HOST_FNS: dict[str, Any] = {
    "avg": _h_avg,
    "mean": _h_avg,
    "sum": lambda x: np.asarray(x).sum(),
    "min": lambda x: np.asarray(x).min(),
    "max": lambda x: np.asarray(x).max(),
    "count": lambda x: np.asarray(x).size,
    "sqrt": np.sqrt,
    "pow": np.power,
    "abs": np.abs,
    "exp": np.exp,
    "log": np.log,
    "sums": _h_sums,
    "avgs": _h_avgs,
    "mins": lambda x: np.minimum.accumulate(x),
    "maxs": lambda x: np.maximum.accumulate(x),
    "first": lambda x: np.asarray(x)[0],
    "last": lambda x: np.asarray(x)[-1],
    "subvec": lambda x, a, b: np.asarray(x)[int(a): int(b)],
}
