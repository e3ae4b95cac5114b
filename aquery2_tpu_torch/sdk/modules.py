"""LOAD MODULE: Python and C modules whose functions SQL calls.

Counterpart of ``aquery2_tpu/sdk/modules.py`` (the reference's `LOAD MODULE
FROM "lib.so" FUNCTIONS (...)`, which dlopens the library and resolves
each symbol, server.cpp:308-331). The session maps each declared name to
a ``ModuleFunction``; the evaluator calls it like a builtin
(engine/eval.py ``_call``).

A module runs on the host. ``call_module_function`` copies each argument
there: a scalar as a Python value, a row argument with one ``.cpu()``,
``pack(...)`` as one [n, k] matrix, a vector column as its CSR values and
offsets (a uniform width becomes an [n, k] matrix, as the reference's
vecvec arguments are). ``_wrap_result`` brings the answer back: a row of
n values onto the session's device in the declared element type, a
Python scalar as a scalar.

Module kinds:
  * ``.py``: functions receive numpy arrays and Python scalars; the
    module's ``init_session(session)``, if any, runs at load;
  * ``.so``: the plain C ABI of sdk/aquery_tpu_module.h through ctypes
    (scalars by value, vec<T> as pointer and length, vecvec<T> as
    pointer, rows and columns; a vector result fills a caller's buffer
    and returns its length).
"""

from __future__ import annotations

import ctypes
import importlib.util
import os
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from aquery2_tpu_torch import types as T
from aquery2_tpu_torch.parser import ast_nodes as A


@dataclass
class ModuleFunction:
    name: str
    params: list[tuple[str, T.SQLType]]
    ret_type: T.SQLType
    fn: Callable


def load_module(session, stmt: A.LoadModule) -> None:
    path = session.resolve_path(stmt.path)
    if path.endswith(".py") or os.path.exists(path + ".py"):
        if not path.endswith(".py"):
            path = path + ".py"
        mod = _load_python_module(path)

        def getter(name):
            return getattr(mod, name)
    elif path.endswith(".so"):
        lib = ctypes.CDLL(path)

        def getter(name):
            try:
                return getattr(lib, name)
            except AttributeError:
                raise AttributeError(
                    f"symbol {name} not found in module") from None
    else:
        raise ValueError(f"unsupported module type: {path}")

    for sig in stmt.functions:
        params = [(n, T.from_sql_name(t)) for n, t in sig.params]
        ret = T.from_sql_name(sig.ret_type)
        raw = getter(sig.name)
        if path.endswith(".so"):
            raw = _bind_c_signature(raw, params, ret)
        session.module_functions[sig.name.lower()] = ModuleFunction(
            sig.name.lower(), params, ret, raw)
    if path.endswith(".py"):
        init = getattr(mod, "init_session", None)
        if init is not None:
            init(session)


def _load_python_module(path: str):
    name = "aq_module_" + os.path.basename(path)[:-3]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --- the C ABI (sdk/aquery_tpu_module.h) ------------------------------------

_C_SCALAR = {
    "int": ctypes.c_int32, "bool": ctypes.c_bool, "tinyint": ctypes.c_int8,
    "smallint": ctypes.c_int16, "bigint": ctypes.c_int64,
    "real": ctypes.c_float, "double": ctypes.c_double,
}


def _bind_c_signature(cfn, params, ret: T.SQLType):
    """A wrapper that passes numpy arrays and scalars to the C ABI:
    scalar → by value; vec<T> → (const T* data, int64 len); vecvec<T> →
    (const T* data, int64 rows, int64 cols), row-major. A vector result:
    int64 f(..., T* out, int64 out_cap) fills out and returns its
    length."""

    def wrapper(*args):
        cargs: list[Any] = []
        keepalive: list[np.ndarray] = []    # the buffers, for the call
        n_rows = 0
        for (_, pt), a in zip(params, args):
            if pt.is_vector and pt.elem is not None and pt.elem.is_vector:
                arr = np.ascontiguousarray(a, dtype=pt.elem.elem.np_dtype)
                assert arr.ndim == 2
                n_rows = arr.shape[0]
                cargs += [arr.ctypes.data_as(ctypes.c_void_p),
                          ctypes.c_int64(arr.shape[0]),
                          ctypes.c_int64(arr.shape[1])]
                keepalive.append(arr)
            elif pt.is_vector:
                arr = np.ascontiguousarray(a, dtype=pt.elem.np_dtype)
                n_rows = max(n_rows, arr.shape[0])
                cargs += [arr.ctypes.data_as(ctypes.c_void_p),
                          ctypes.c_int64(arr.shape[0])]
                keepalive.append(arr)
            else:
                ct = _C_SCALAR.get(pt.name, ctypes.c_double)
                cargs.append(ct(a.item() if hasattr(a, "item") else a))
        if ret.is_vector:
            out = np.zeros(max(n_rows, 1), dtype=ret.elem.np_dtype)
            cfn.restype = ctypes.c_int64
            m = cfn(*cargs, out.ctypes.data_as(ctypes.c_void_p),
                    ctypes.c_int64(out.shape[0]))
            del keepalive
            return out[:m]
        cfn.restype = _C_SCALAR.get(ret.name, ctypes.c_double)
        res = cfn(*cargs)
        del keepalive
        return res

    return wrapper


# --- the evaluator's call ---------------------------------------------------

def call_module_function(ctx, fn: ModuleFunction, arg_exprs: list):
    """Evaluate the arguments, copy them to the host, call fn, and wrap
    its answer as a Value."""
    args = []
    n = ctx.ws.n
    for e in arg_exprs:
        if isinstance(e, A.ColumnRef) and ctx.ws.has_column(e.name, e.table):
            si, col = ctx.ws.find(e.name, e.table)
            if col.is_vector:
                idx = ctx.ws.indices[si]
                args.append(_vector_rows(
                    col, None if idx is None else idx[:n].cpu().numpy()))
                continue
        v = ctx.eval(e)
        if v.pack_cols is not None:
            dt = v.pack_cols[0].dtype
            for c in v.pack_cols[1:]:
                dt = torch.promote_types(dt, c.dtype)
            args.append(torch.stack([c[:n].to(dt) for c in v.pack_cols],
                                    dim=1).cpu().numpy())
        elif v.kind == "scalar":
            d = v.data
            args.append(d.item() if isinstance(d, torch.Tensor) else d)
        else:
            args.append(ctx.to_row(v).data[:n].cpu().numpy())
    return _wrap_result(ctx, fn.fn(*args), fn.ret_type)


def _vector_rows(col, rows: np.ndarray | None):
    """The vector column's rows (all, or those of ``rows``) on the host:
    an [n, k] matrix if every row holds k values, else a list of arrays."""
    offs = col.offsets_numpy()
    vals = col.to_numpy()
    if rows is None:
        rows = np.arange(col.nrows)
    starts, lens = offs[rows], offs[rows + 1] - offs[rows]
    if len(rows) and (lens == lens[0]).all():
        return vals[starts[:, None] + np.arange(lens[0])]
    return [vals[s:s + k] for s, k in zip(starts, lens)]


def _wrap_result(ctx, res, ret_type: T.SQLType):
    from aquery2_tpu_torch.engine.eval import Value

    if res is None:
        return Value("scalar", True, T.BoolT)
    if isinstance(res, (bool, np.bool_)):
        return Value("scalar", bool(res), T.BoolT)
    if isinstance(res, (int, np.integer)):
        return Value("scalar", int(res), T.LongT)
    if isinstance(res, (float, np.floating)):
        return Value("scalar", float(res), T.DoubleT)
    arr = np.asarray(res)
    elem = ret_type.elem if ret_type.is_vector else ret_type
    if arr.ndim == 1 and arr.shape[0] == ctx.ws.n:
        out = torch.zeros(ctx.ws.capacity, dtype=T.torch_dtype(elem.np_dtype),
                          device=ctx.ws.device)
        out[:arr.shape[0]] = torch.from_numpy(
            np.ascontiguousarray(arr, dtype=elem.np_dtype)).to(out.device)
        return Value("row", out, elem)
    # any other length: one vector value
    return Value("scalar", arr.tolist(), T.VectorT(elem))
