"""The C++ CSV scanner (csvscan.cpp) through ctypes.

Counterpart of ``aquery2_tpu/native/__init__.py``. The library is built
at first use with the host's C++ compiler (``$CXX``, else g++) into
``build/aquery2_tpu_torch/`` at the root of the checkout, named by a hash
of the source and the flags, so an edit rebuilds it. Unlike the JAX
package, nothing falls back: a failed build raises with the compiler's
stderr, and a cell or line the scanner cannot read raises ValueError.

``parse_numeric_csv`` is the route of storage/csvio.py for a plain LOAD
of a table whose columns are all int32, int64, float32 or float64
(``SPEC``) with a one-byte separator.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csvscan.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "aquery2_tpu_torch"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-pthread", "-std=c++17")
SPEC = {"int32": b"i", "int64": b"l", "float32": b"f", "float64": b"d"}

_vp = ctypes.c_void_p


def library_path() -> Path:
    """Where the scanner's library for the current source lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libaqcsv_{h.hexdigest()[:16]}.so"


@functools.cache
def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the scanner's library;
    raises RuntimeError with the compiler's stderr if the build fails."""
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            out = os.path.join(tmp, so.name)
            cxx = os.environ.get("CXX", "g++")
            try:
                p = subprocess.run([cxx, *CXX_FLAGS, "-o", out, str(SOURCE)],
                                   capture_output=True, text=True)
            except OSError as e:
                raise RuntimeError(f"the CSV scanner's build failed: {e}") \
                    from e
            if p.returncode:
                raise RuntimeError(
                    f"the CSV scanner's build failed:\n{p.stderr}")
            os.replace(out, so)
    lib = ctypes.CDLL(str(so))
    lib.aq_csv_count_rows.restype = ctypes.c_int64
    lib.aq_csv_count_rows.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                      ctypes.c_char, ctypes.c_int]
    lib.aq_csv_parse.restype = ctypes.c_int
    lib.aq_csv_parse.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_char, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(_vp),
        ctypes.POINTER(_vp), ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int64)]
    return lib


def parse_numeric_csv(path: str, dtypes: list[np.dtype], sep: str,
                      skip_header: bool
                      ) -> tuple[list[np.ndarray], list[np.ndarray | None]]:
    """The file's columns and, per column, its validity (None where no
    cell was empty). An empty or blank cell is NULL: 0 and validity
    False. Raises ValueError naming the first cell that does not parse
    or the first line whose field count is not len(dtypes)."""
    spec = b"".join(SPEC[np.dtype(dt).name] for dt in dtypes)
    lib = build()
    with open(path, "rb") as f:
        data = f.read()
    sepb = sep.encode()
    skip = 1 if skip_header else 0
    nrows = int(lib.aq_csv_count_rows(data, len(data), sepb, skip))
    cols = [np.zeros(nrows, dt) for dt in dtypes]
    valids = [np.ones(nrows, np.uint8) for _ in dtypes]
    if nrows == 0:
        return cols, [None] * len(dtypes)
    ptrs = (_vp * len(cols))(*[c.ctypes.data for c in cols])
    vptrs = (_vp * len(cols))(*[v.ctypes.data for v in valids])
    null_counts = (ctypes.c_int64 * len(cols))()
    bad = (ctypes.c_int64 * 2)(-1, -1)
    rc = lib.aq_csv_parse(data, len(data), sepb, skip, spec, len(cols),
                          ptrs, vptrs, null_counts, nrows,
                          min(os.cpu_count() or 1, 16), bad)
    if rc == -3:
        raise ValueError(
            f"{path}: data row {bad[0] + 1}, column {bad[1] + 1}: not a "
            f"{np.dtype(dtypes[bad[1]])} value, or the line does not hold "
            f"{len(dtypes)} fields")
    if rc:
        raise ValueError(f"{path}: the CSV scanner failed ({rc})")
    masks = [valids[i].astype(bool) if null_counts[i] else None
             for i in range(len(cols))]
    return cols, masks
