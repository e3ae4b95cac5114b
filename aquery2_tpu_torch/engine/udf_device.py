"""AGGREGATION FUNCTION bodies on the device, batched over the groups.

Counterpart of ``aquery2_tpu/engine/udf_device.py``. The reference
compiles a body into a C++ lambda called once per group
(engine/ast.py:1551-1812); the JAX package traces one group's body and
vmaps it, its loops ``lax.while_loop``s. ``torch.func.vmap`` does not
lift a loop whose trip count depends on the data, so here the body is
evaluated once, for every group at a time:

* a scalar variable is a float64 (or bool) tensor [G], or a Python number
  where it is the same for every group (literals, literal arguments and
  what is computed from them alone, in float64 as numpy computes it);
* a vector is a ``_Vec``: data [G, L] float64 and mask [G, L] over the
  padded group matrix; x(a, b) and subvec(x, a, b) refine the mask
  against an iota [L], so no shape depends on the data;
* ``_builtin_len`` is the [G] lengths, ``_builtin_ret`` a [G, L] float64
  tensor; ``x[i]`` with a per-group index is a gather along dim 1, the
  index clipped to [0, L - 1] as the JAX package clips it;
* every assignment is gated by the groups it applies to (``active``):
  if/elif/else evaluates all its conditions from the pre-if state, then
  runs each branch with ``active`` narrowed to the groups that take it,
  so a variable keeps its old value elsewhere (``torch.where``; a new
  variable is 0 there, as the JAX package's merge makes it); an indexed
  write ``name[i] := v`` is a scatter of v where the group is active and
  of the old element elsewhere;
* a for loop is a Python loop over a per-group ``active`` mask: each
  pass evaluates the condition for every group, narrows ``active`` to
  the groups for which it holds, and runs the body and the step under
  it. That is what vmap of ``lax.while_loop`` computes: a group whose
  loop has ended keeps its values, and an operation on its lanes (a
  division by zero) is discarded by the gate. The loop ends when no
  group is active; reading that is a host sync, made after the 1st,
  2nd, 4th, 8th, 16th and 32nd condition and then every ``_CHECK_EVERY``
  (32) conditions, so a loop of n passes makes about
  5 + max(1, (n + 1 - 16) / 32) syncs and runs at most 31 masked passes
  past its end, which change nothing.

The body's AST is made into closures once per call (``_compile_block``),
so a pass dispatches on no AST node; what a value is (a constant, [G],
[G, L] or a ``_Vec``) is still decided as it is computed.

Length classes: the groups are sorted by length into power-of-two
classes (len ≤ 1, 2, ≤ 4, ≤ 8, ...), and each class runs the body on its
own [G_c, L_c] matrix, so the padding stays below twice the rows
whatever the skew; there is no size gate. One host sync reads the class
counts. The results go back to group order (a scalar body) or to the
rows (``_builtin_ret``, through each row's group start and position).
A matrix is gathered at start + arange(L_c) clipped to the capacity, so
a read past a group's end (undefined in the reference) reads the rows
after it up to L_c, and the last of those beyond; the JAX package's
matrix reaches as far as the longest group (ROADMAP queue 3).

A NULL argument row reads its stored value, as both JAX paths do.

``_Untraceable`` is the one exception that sends a call to the host
interpreter (engine/udf.run_aggregation_udf): a decision about the
body's shape (an unbound name, a NULL literal in an expression, an
unknown call or operator, a loop that mutates no variable bound before
it, a branch or loop that changes a variable's rank, a scalar body that
returns nothing). Every other error propagates.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from aquery2_tpu_torch import types as T
from aquery2_tpu_torch.parser import ast_nodes as A

_CHECK_EVERY = 32               # loop passes between host checks, at most
_MAX_PASSES = 100_000_000       # the host interpreter's runaway guard
_AUG = {"+=": "+", "-=": "-", "*=": "*", "/=": "/"}


class _Untraceable(Exception):
    pass


@dataclass
class _Vec:
    data: torch.Tensor          # [G, L] float64
    mask: torch.Tensor          # [G, L] bool: the rows this vector covers


def _collect_assigned(body, out: set[str]) -> None:
    for s in body:
        if isinstance(s, A.UdfAssign):
            if isinstance(s.target, A.ColumnRef):
                out.add(s.target.name)
            elif isinstance(s.target, A.Index) and \
                    isinstance(s.target.base, A.ColumnRef):
                out.add(s.target.base.name)
        elif isinstance(s, A.UdfIf):
            _collect_assigned(s.then, out)
            for _, blk in s.elifs:
                _collect_assigned(blk, out)
            _collect_assigned(s.orelse, out)
        elif isinstance(s, A.UdfFor):
            _collect_assigned(list(s.init) + list(s.step) + list(s.body),
                              out)


def _returns_vector(body) -> bool:
    """Statically: does the body write _builtin_ret?"""
    hit: set[str] = set()
    _collect_assigned(body, hit)
    return "_builtin_ret" in hit


def _is_mat(v) -> bool:
    return isinstance(v, torch.Tensor) and v.dim() == 2


def _col(v):
    """A per-group scalar as a [G, 1] column beside [G, L] matrices."""
    return v.unsqueeze(1) if isinstance(v, torch.Tensor) and v.dim() == 1 \
        else v


def _num(v):
    """Bool tensors as float64 (arithmetic and comparisons promote bool to
    float64, as jnp does; a Python float beside a bool tensor would give
    float32 in torch)."""
    if isinstance(v, torch.Tensor) and v.dtype == torch.bool:
        return v.to(torch.float64)
    return v


def _const_op(op: str, a, b):
    """op over two per-call constants, in numpy's float64."""
    x, y = np.float64(a), np.float64(b)
    with np.errstate(all="ignore"):
        r = {"+": np.add, "-": np.subtract, "*": np.multiply,
             "/": np.true_divide, "%": np.mod, "=": np.equal,
             "<>": np.not_equal, "<": np.less, ">": np.greater,
             "<=": np.less_equal, ">=": np.greater_equal,
             "and": np.logical_and, "or": np.logical_or}[op](x, y)
    return bool(r) if isinstance(r, np.bool_) else float(r)


_ARITH = {"+": lambda a, b: a + b, "-": lambda a, b: a - b,
          "*": lambda a, b: a * b, "/": lambda a, b: a / b,
          "%": lambda a, b: a % b,
          "=": lambda a, b: a == b, "<>": lambda a, b: a != b,
          "<": lambda a, b: a < b, ">": lambda a, b: a > b,
          "<=": lambda a, b: a <= b, ">=": lambda a, b: a >= b}


def _logic(op: str, a, b):
    """and/or of two operands, at least one a tensor."""
    def truth(v):
        if isinstance(v, torch.Tensor):
            return v if v.dtype == torch.bool else v != 0
        return bool(v)
    a, b = truth(a), truth(b)
    if not isinstance(a, torch.Tensor):
        a, b = b, a
    if isinstance(b, bool):
        if op == "and":
            return a if b else torch.zeros_like(a)
        return torch.ones_like(a) if b else a
    return (a & b) if op == "and" else (a | b)


_ELEMENTWISE = {          # name: (on tensors, on per-call constants)
    "sqrt": (torch.sqrt, np.sqrt), "abs": (torch.abs, np.abs),
    "exp": (torch.exp, np.exp), "log": (torch.log, np.log),
    "pow": (torch.pow, np.power), "floor": (torch.floor, np.floor),
    "ceil": (torch.ceil, np.ceil), "round": (torch.round, np.round),
    "sign": (torch.sign, np.sign),
}


def _elementwise(name: str, args):
    """An elementwise function of its arguments: tensors (bool as
    float64) or, where none is a tensor, constants in numpy's float64."""
    tf, nf = _ELEMENTWISE[name]
    if not any(isinstance(a, torch.Tensor) for a in args):
        with np.errstate(all="ignore"):
            return float(nf(*[np.float64(a) for a in args]))
    args = [_num(a) for a in args]
    return tf(args[0], args[1]) if name == "pow" else tf(args[0])


class _Tracer:
    """One class of groups' state: G groups of at most L rows, the
    variables (``env``) and the groups a statement may change
    (``active``, None for every group). The body runs as closures that
    ``_compile`` made of its AST, which call the methods here."""

    def __init__(self, env: dict[str, Any], G: int, L: int,
                 device: torch.device) -> None:
        self.env = env
        self.G, self.L, self.device = G, L, device
        self.iota = torch.arange(L, device=device)
        self.active: torch.Tensor | None = None
        self._index = (None, None)                # the last index converted

    # -- assignments -------------------------------------------------------

    def _set(self, name: str, val) -> None:
        """name := val for the active groups."""
        if self.active is None:
            self.env[name] = val
            return
        old = self.env.get(name)
        if old is None:                         # new here: 0 elsewhere
            if isinstance(val, _Vec):
                old = _Vec(torch.zeros_like(val.data), val.mask)
            elif _is_mat(val):
                old = torch.zeros_like(val)
            else:
                old = 0.0
        self.env[name] = self._merge(self.active, val, old)

    def _merge(self, cond: torch.Tensor, a, b):
        if type(a) is torch.Tensor and type(b) is torch.Tensor \
                and a.dtype == b.dtype and a.dim() == b.dim() == 1:
            return torch.where(cond, a, b)
        if isinstance(a, _Vec) or isinstance(b, _Vec):
            if not (isinstance(a, _Vec) and isinstance(b, _Vec)):
                raise _Untraceable("branch changes variable rank")
            c = cond.unsqueeze(1)
            return _Vec(torch.where(c, a.data, b.data),
                        torch.where(c, a.mask, b.mask))
        if _is_mat(a) or _is_mat(b):
            if not (_is_mat(a) and _is_mat(b)):
                raise _Untraceable("branch changes variable shape")
            return torch.where(cond.unsqueeze(1), a, b)
        if not isinstance(a, torch.Tensor) and not isinstance(b,
                                                             torch.Tensor) \
                and type(a) is type(b) and a == b:
            return a
        a, b = self._rows(a), self._rows(b)
        if a.dtype != b.dtype:
            a, b = a.to(torch.float64), b.to(torch.float64)
        return torch.where(cond, a, b)

    def _rows(self, v) -> torch.Tensor:
        """A scalar value as a [G] tensor."""
        if isinstance(v, torch.Tensor):
            return v
        return torch.full((self.G,), v, device=self.device,
                          dtype=torch.bool if isinstance(v, bool)
                          else torch.float64)

    def _truth(self, v) -> torch.Tensor:
        if type(v) is torch.Tensor and v.dtype == torch.bool \
                and v.dim() == 1:
            return v
        if isinstance(v, _Vec) or _is_mat(v):
            raise _Untraceable("condition is a vector")
        v = self._rows(v)
        return v if v.dtype == torch.bool else v != 0

    # -- control flow ------------------------------------------------------

    def _if(self, conds, blocks) -> None:
        """Every condition from the pre-if state, then each branch under
        the groups that take it (the JAX package's evaluate-and-merge)."""
        cs = [self._truth(c(self)) for c in conds]
        outer = self.active
        taken = None
        for i, blk in enumerate(blocks):
            if i < len(cs):
                c = cs[i]
                take = c if taken is None else c & ~taken
                taken = c if taken is None else taken | c
            else:
                take = ~taken
            if blk is None:
                continue
            self.active = take if outer is None else take & outer
            blk(self)
        self.active = outer

    def _for(self, init, cond, body, step, mutated) -> None:
        for a in init:
            a(self)
        if not any(n in self.env for n in mutated):
            raise _Untraceable("loop mutates nothing")
        outer = active = self.active
        passes, check = 0, 1
        while True:
            c = self._truth(cond(self))
            active = c if active is None else active & c
            passes += 1
            if passes == check:
                if not bool(active.any()):      # host sync
                    break
                check += min(check, _CHECK_EVERY)
            if passes > _MAX_PASSES:
                from aquery2_tpu_torch.engine.udf import UdfError

                raise UdfError("runaway FUNCTION loop")
            self.active = active
            body(self)
            for a in step:
                a(self)
        self.active = outer

    # -- element access ---------------------------------------------------

    def _as_index(self, v):
        """An element index, clipped to [0, L - 1] (int for a constant,
        int64 [G] otherwise)."""
        if self._index[0] is v:
            return self._index[1]
        if not isinstance(v, torch.Tensor):
            return min(max(int(v), 0), self.L - 1)
        if v.dim() != 1:
            raise _Untraceable("vector index")
        idx = v.to(torch.int64).clamp_(0, self.L - 1)
        self._index = (v, idx)
        return idx

    def _read(self, data: torch.Tensor, idx) -> torch.Tensor:
        if isinstance(idx, int):
            return data[:, idx].clone()
        return data.gather(1, idx.unsqueeze(1)).squeeze(1)

    def _element(self, base, index):
        idx = self._as_index(index)
        if isinstance(base, _Vec):
            return self._read(base.data, idx)
        if _is_mat(base):
            return self._read(base, idx)
        raise _Untraceable("index of a scalar")

    def _write(self, arr: torch.Tensor, idx, val) -> None:
        """arr[g, idx[g]] := val[g] in place where the group is active
        (the arrays in env are never shared: an assignment copies)."""
        if isinstance(val, _Vec) or _is_mat(val):
            raise _Untraceable("vector written to an element")
        v = self._rows(_num(val)).to(torch.float64)
        if self.active is not None:
            v = torch.where(self.active, v, self._read(arr, idx))
        if isinstance(idx, int):
            arr[:, idx] = v
        else:
            arr.scatter_(1, idx.unsqueeze(1), v.unsqueeze(1))

    def _span(self, a, b) -> torch.Tensor:
        """[G, L] (or [L]) mask of the positions in [a, b), a and b
        truncated to integers."""
        a = a.to(torch.int64).unsqueeze(1) if isinstance(a, torch.Tensor) \
            else int(a)
        b = b.to(torch.int64).unsqueeze(1) if isinstance(b, torch.Tensor) \
            else int(b)
        return (self.iota >= a) & (self.iota < b)

    # -- expressions -------------------------------------------------------

    def _lookup(self, name: str):
        env = self.env
        if name in env:
            return env[name]
        low = name.lower()
        if low in env:
            return env[low]
        raise _Untraceable(f"unbound {name}")

    def _unary(self, op: str, v):
        if op == "-":
            if isinstance(v, _Vec):
                return _Vec(-v.data, v.mask)
            return -_num(v)
        if op == "not" and not (isinstance(v, _Vec) or _is_mat(v)):
            if isinstance(v, torch.Tensor):
                return torch.logical_not(v)
            return not v
        raise _Untraceable(f"unary {op}")

    def _binop(self, op: str, a, b):
        f = _ARITH.get(op)
        if f is not None and type(a) is torch.Tensor \
                and type(b) is not _Vec and a.dtype == torch.float64 \
                and a.dim() == 1 and (type(b) is float or (
                    type(b) is torch.Tensor and b.dtype == torch.float64
                    and b.dim() == 1)):
            return f(a, b)                      # the common case
        if op in ("and", "or"):
            def f(x, y):
                return _logic(op, x, y)
        else:
            if f is None:
                raise _Untraceable(f"op {op}")
            a, b = _num(a), _num(b)
        if isinstance(a, _Vec) or isinstance(b, _Vec):
            if isinstance(a, _Vec) and isinstance(b, _Vec):
                return _Vec(f(a.data, b.data), a.mask & b.mask)
            if isinstance(a, _Vec):
                return _Vec(f(a.data, _col(b)), a.mask)
            return _Vec(f(_col(a), b.data), b.mask)
        if not isinstance(a, torch.Tensor) and not isinstance(b,
                                                             torch.Tensor):
            return _const_op(op, a, b)
        if _is_mat(a) or _is_mat(b):
            a, b = _col(a), _col(b)
        return f(a, b)

    def _call(self, name: str, fargs):
        tgt = self.env.get(name)
        if isinstance(tgt, _Vec) and len(fargs) == 2:      # x(a, b)
            a, b = fargs[0](self), fargs[1](self)
            return _Vec(tgt.data, tgt.mask & self._span(a, b))
        args = [f(self) for f in fargs]
        if name == "subvec" and args and isinstance(args[0], _Vec):
            v, a, b = args
            return _Vec(v.data, v.mask & self._span(a, b))
        if name in _REDUCERS:
            return _REDUCERS[name](self, args)
        if name in _ELEMENTWISE:
            v = args[0]
            if isinstance(v, _Vec):
                return _Vec(_elementwise(
                    name, [v.data, *[_col(a) for a in args[1:]]]), v.mask)
            if _is_mat(v):
                return _elementwise(name, [v, *[_col(a) for a in args[1:]]])
            return _elementwise(name, args)
        raise _Untraceable(f"call {name}")


# --------------------------------------------------------------------- #
# the body's AST as closures over a _Tracer, made once per call: the
# loop's passes then run no AST dispatch
# --------------------------------------------------------------------- #

def _raising(why: str):
    def run(tr):
        raise _Untraceable(why)
    return run


def _compile_expr(e):
    if isinstance(e, A.Literal):
        if e.value is None:
            return _raising("null literal in expression")
        if e.is_string:
            return _raising("string literal in expression")
        v = float(e.value)
        return lambda tr: v
    if isinstance(e, A.ColumnRef):
        name = e.name
        return lambda tr: tr._lookup(name)
    if isinstance(e, A.Index):
        fb, fi = _compile_expr(e.base), _compile_expr(e.index)
        return lambda tr: tr._element(fb(tr), fi(tr))
    if isinstance(e, A.UnaryOp):
        op, f = e.op, _compile_expr(e.operand)
        return lambda tr: tr._unary(op, f(tr))
    if isinstance(e, A.BinOp):
        op, fl, fr = e.op, _compile_expr(e.left), _compile_expr(e.right)
        return lambda tr: tr._binop(op, fl(tr), fr(tr))
    if isinstance(e, A.Call):
        name, fargs = e.func, [_compile_expr(a) for a in e.args]
        return lambda tr: tr._call(name, fargs)
    return _raising(f"expr {e}")


def _compile_assign(s: A.UdfAssign):
    fv, op = _compile_expr(s.value), s.op
    if isinstance(s.target, A.ColumnRef):
        name = s.target.name
        if op == ":=":
            def run(tr):
                val = fv(tr)
                if _is_mat(val):
                    val = val.clone()           # value semantics
                tr._set(name, val)
        else:
            bop = _AUG[op]

            def run(tr):
                val = fv(tr)
                tr._set(name, tr._binop(bop, tr._lookup(name), val))
        return run
    if isinstance(s.target, A.Index) and \
            isinstance(s.target.base, A.ColumnRef):
        name, fi = s.target.base.name, _compile_expr(s.target.index)

        def run(tr):
            val = fv(tr)
            arr = tr._lookup(name)
            if isinstance(arr, _Vec):
                raise _Untraceable("indexed write to input vector")
            if not _is_mat(arr):
                raise _Untraceable("indexed write to a scalar")
            idx = tr._as_index(fi(tr))
            if op != ":=":
                val = tr._binop(_AUG[op], tr._read(arr, idx), val)
            tr._write(arr, idx, val)
        return run
    return _raising("assignment target")


def _compile_stmt(s):
    """A statement as a closure returning its value (a bare expression's,
    else None)."""
    if isinstance(s, A.UdfAssign):
        f = _compile_assign(s)

        def run(tr):
            f(tr)
        return run
    if isinstance(s, A.UdfExprStmt):
        e = s.expr
        if (isinstance(e, A.Literal) and e.value is None) or (
                isinstance(e, A.ColumnRef) and e.name.lower() == "null"):
            return lambda tr: None              # `Null`: return the ret
        return _compile_expr(e)
    if isinstance(s, A.UdfIf):
        conds = [_compile_expr(c) for c in [s.cond] + [c for c, _ in s.elifs]]
        blocks = [_compile_block(b) if b else None
                  for b in [s.then] + [b for _, b in s.elifs] + [s.orelse]]

        def run(tr):
            tr._if(conds, blocks)
        return run
    if isinstance(s, A.UdfFor):
        init = [_compile_assign(a) for a in s.init]
        step = [_compile_assign(a) for a in s.step]
        cond, body = _compile_expr(s.cond), _compile_block(s.body)
        mutated: set[str] = set()
        _collect_assigned(list(s.body) + list(s.step), mutated)

        def run(tr):
            tr._for(init, cond, body, step, mutated)
        return run
    return _raising(f"statement {s}")


def _compile_block(body):
    """Statements as one closure returning the last one's value."""
    fs = [_compile_stmt(s) for s in body]

    def run(tr):
        last = None
        for f in fs:
            last = f(tr)
        return last
    return run


# --------------------------------------------------------------------- #
# reducers over a vector's masked rows (a scalar passes through)
# --------------------------------------------------------------------- #

def _red_sum(tr, args):
    v = args[0]
    if not isinstance(v, _Vec):
        return v
    return torch.where(v.mask, v.data, 0.0).sum(1)


def _red_count(tr, args):
    v = args[0]
    if not isinstance(v, _Vec):
        return 1.0
    return v.mask.sum(1, dtype=torch.float64)


def _red_avg(tr, args):
    v = args[0]
    if not isinstance(v, _Vec):
        return v
    c = v.mask.sum(1, dtype=torch.float64)
    return torch.where(v.mask, v.data, 0.0).sum(1) / c.clamp(min=1.0)


def _red_min(tr, args):
    v = args[0]
    if not isinstance(v, _Vec):
        return v
    return torch.where(v.mask, v.data, float("inf")).amin(1)


def _red_max(tr, args):
    v = args[0]
    if not isinstance(v, _Vec):
        return v
    return torch.where(v.mask, v.data, float("-inf")).amax(1)


def _red_first(tr, args):
    v = args[0]
    if not isinstance(v, _Vec):
        return v
    i = v.mask.to(torch.uint8).argmax(1)        # the first covered row
    return v.data.gather(1, i.unsqueeze(1)).squeeze(1)


def _red_last(tr, args):
    v = args[0]
    if not isinstance(v, _Vec):
        return v
    i = tr.L - 1 - v.mask.flip(1).to(torch.uint8).argmax(1)
    return v.data.gather(1, i.unsqueeze(1)).squeeze(1)


_REDUCERS = {
    "sum": _red_sum, "avg": _red_avg, "mean": _red_avg,
    "count": _red_count, "min": _red_min, "max": _red_max,
    "first": _red_first, "last": _red_last,
}


# --------------------------------------------------------------------- #
# the batched body over length classes
# --------------------------------------------------------------------- #

def length_classes(lens: torch.Tensor):
    """(order [G] int64, counts [65] int64) on the device: the groups
    sorted by class, and each class's count. Class c holds the groups of
    2^(c-1) < len ≤ 2^c rows (class 0: len ≤ 1); no group reaches class
    64. The counts are bounds searched in the sorted classes."""
    cls = torch.frexp((lens - 1).clamp(min=0).to(torch.float64)).exponent
    sorted_cls, order = torch.sort(cls, stable=True)
    bounds = torch.searchsorted(sorted_cls, torch.arange(
        66, dtype=sorted_cls.dtype, device=lens.device))
    return order, (bounds[1:] - bounds[:-1]).to(torch.int64)


def _run_class(body, mats, scalars, lens: torch.Tensor, L: int,
               ret_vec: bool) -> torch.Tensor:
    """The compiled body over G groups of at most L rows: [G] float64 (a
    scalar body) or the [G, L] float64 _builtin_ret."""
    G, dev = int(lens.shape[0]), lens.device
    env: dict[str, Any] = {}
    mask = torch.arange(L, device=dev) < lens.unsqueeze(1)
    for p, data in mats:
        env[p] = _Vec(data, mask)
    for p, s in scalars:
        env[p] = s
    env["_builtin_len"] = lens.to(torch.float64)
    env["_builtin_ret"] = torch.zeros(G, L, dtype=torch.float64, device=dev)
    res = body(_Tracer(env, G, L, dev))
    if ret_vec:
        ret = env["_builtin_ret"]
        if not _is_mat(ret):
            raise _Untraceable("_builtin_ret is not a vector")
        return ret
    if res is None or isinstance(res, _Vec) or _is_mat(res):
        raise _Untraceable("scalar UDF returned nothing")
    if not isinstance(res, torch.Tensor):
        return torch.full((G,), float(res), dtype=torch.float64, device=dev)
    return res.to(torch.float64)


def run_groups(udf, columns, scalars, starts: torch.Tensor,
               lens: torch.Tensor, order: torch.Tensor, counts: list[int],
               ret_vec: bool, cap: int) -> torch.Tensor:
    """The body over every group, class by class.

    columns: (parameter, [cap] row tensor) in the group-major row layout;
    scalars: (parameter, Python number); starts, lens: [G] int64 group
    spans in that layout; order and counts: length_classes' (counts read
    on the host). Returns [G] float64 (a scalar body) or the [cap]
    float64 row values of _builtin_ret."""
    dev = lens.device
    G = int(lens.shape[0])
    out = torch.zeros(cap + 1 if ret_vec else G, dtype=torch.float64,
                      device=dev)
    body = _compile_block(udf.body)
    off = 0
    for c, n_c in enumerate(counts[:64]):
        if not n_c:
            continue
        gi = order[off:off + n_c]
        off += n_c
        L = 1 << c
        iota = torch.arange(L, device=dev)
        ln = lens[gi]
        pos = starts[gi].unsqueeze(1) + iota
        col = pos.clamp(0, cap - 1)
        mats = [(p, rows[col].to(torch.float64)) for p, rows in columns]
        res = _run_class(body, mats, scalars, ln, L, ret_vec)
        if ret_vec:
            dst = torch.where(iota < ln.unsqueeze(1), pos, cap)
            out.index_put_((dst.reshape(-1),), res.reshape(-1))
        else:
            out.index_put_((gi,), res)
    return out[:cap] if ret_vec else out


def try_run_aggregation_udf(ctx, udf, args):
    """The batched device body of an AGGREGATION FUNCTION call in the
    general pipeline: a Value (group kind for a scalar body, row kind for
    _builtin_ret), or None where the body is untraceable."""
    from aquery2_tpu_torch.engine.eval import Value

    G = ctx.G
    columns, scalars = [], []
    for p, v in zip(udf.params, args):
        if v.kind == "scalar":
            scalars.append((p, float(v.data)))
        else:
            columns.append((p, ctx.to_row(v).data))
    ret_vec = _returns_vector(udf.body)
    lens = ctx.group_lens[:G]
    order, counts = length_classes(lens)
    try:
        out = run_groups(udf, columns, scalars, ctx.group_starts[:G], lens,
                         order, counts.tolist(), ret_vec,     # host sync
                         ctx.ws.capacity)
    except _Untraceable:
        return None
    if ret_vec:
        return Value("row", out, T.DoubleT)
    return Value("group", torch.cat([out, out.new_zeros(ctx.gcap - G)]),
                 T.DoubleT)
