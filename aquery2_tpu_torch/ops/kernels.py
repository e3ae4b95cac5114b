"""The port's hand-written CUDA kernels, each beside its plain version.

Counterpart of ``aquery2_tpu/ops/pallas_kernels.py``: one kernel for each
of its four TPU kernels.

* ``seg_cumsum_i64`` — inclusive segmented 64-bit running sum
  (csrc/seg_cumsum_i64.cu), replacing the TPU kernel
  ``pallas_kernels.seg_cumsum_i64`` (``_make_segsum64_kernel``). Runs the
  packed group-by tier's sums.
* ``seg_scan_multi`` — up to 4 inclusive segmented add/min/max scans
  sharing one flag array (csrc/seg_scan_multi.cu), replacing the TPU
  kernel ``pallas_kernels.seg_scan_multi`` (``_make_segscan_kernel``),
  with float32/int32 lanes as the TPU kernel has and float64/int64 lanes
  besides (which the JAX package scans with XLA's doubling). Runs the
  sorted reduction's min/max, the float64 running sums of ops/scan.py and
  the in-segment positions of ops/segment.py.
* ``onehot_segment_sums`` — exact int64 per-slot sums of up to 8 lanes
  over a small slot domain (csrc/onehot_segment_sums.cu), replacing the
  TPU kernel ``pallas_kernels.onehot_segment_sums``
  (``_make_onehot_kernel``) with its caller
  ``reduce._pallas_onehot_reduce``. Runs the dense tier's sums.
* ``fused_running_stats`` — running sum, min and max of a float32 column
  in one scan (csrc/fused_running_stats.cu), replacing the TPU kernel
  ``pallas_kernels.fused_running_stats`` (``_running_kernel``), with its
  ``best_profit`` wrapper. No engine caller, as in the JAX package.

The scans are memory-bound with a carry across blocks. Blocks of a CUDA
grid run in no order, so the TPU kernels' sequential carry in SMEM needs
another way across tiles (csrc/segscan.cuh). Each scan is one launch with
a decoupled look-back (Merrill & Garland 2016): each tile publishes its
fold, finds its carry-in from its predecessors' published folds and
prefixes, and rescans its rows from shared memory, so every input byte is
read once and every output byte written once: 17 B/row for the int64 sum,
8 B/row per 32-bit lane and 16 B/row per 64-bit lane plus 1 B/row of flags
for seg_scan_multi, and 16 B/row for fused_running_stats, whose column is
staged once for its three statistics. The wrappers zero the status words
and tile counter (``torch.zeros``) before each launch. Float add lanes and
the running sums are not bit-reproducible from run to run (the
look-back's association depends on timing); integer lanes, min/max and
integer-valued float sums are exact.
onehot_segment_sums reads its inputs once, in tiles staged by 16-byte
copies (any pointer alignment, any length), and adds into private
per-thread copies of the accumulators where they fit, else into one copy
per warp with shared atomics (``onehot_route`` reports the launch).

Dispatch: a tensor on the CPU goes to the plain PyTorch version (the tests
use it); a CUDA tensor launches the kernel or raises. ``LAUNCHES`` counts
kernel launches, one per wrapper call that launched.

The kernels are compiled at first use with nvcc for sm_90a into a shared
library with a plain C interface (loaded with ctypes), under
``build/aquery2_tpu_torch/`` at the root of the checkout, named by a hash
of the sources and flags so an edit rebuilds it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

LAUNCHES: dict[str, int] = {"seg_cumsum_i64": 0, "seg_scan_multi": 0,
                            "onehot_segment_sums": 0,
                            "fused_running_stats": 0}

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "aquery2_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_OPS = ("add", "min", "max")
# lane code = dtype · 3 + op; the first two are 32-bit words, the rest 64-bit
_LANE_DTYPES = (torch.float32, torch.int32, torch.float64, torch.int64)
_MAX_LANES = 4
ONEHOT_DTYPES = (torch.int64, torch.int32, torch.bool)   # lane dtype codes
ONEHOT_MAX_LANES = 8
# One copy of the [dp][k] int64 accumulators must fit a block's shared
# memory (232,448 bytes on Hopper) beside two stage buffers of 1024 rows of
# codes and 8 int64 lanes: kMaxEntries in onehot_segment_sums.cu.
ONEHOT_MAX_ENTRIES = (232448 - 2 * (1024 * (4 + 8 * 8) + 16 * 9)) // 8
ONEHOT_ROUTE_KEYS = ("private", "copies", "threads", "blocks", "tile_rows",
                     "smem", "blocks_per_sm", "stage_bytes")

_vp = ctypes.c_void_p


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit to build")


def library_path(defines: tuple[str, ...] = ()) -> Path:
    """Where the kernels' shared library for the current sources (and the
    extra nvcc ``defines``, if any) lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + defines).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libaq_kernels_{h.hexdigest()[:16]}.so"


@functools.cache
def build(defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernels' library: one
    nvcc per source, all started together, then one link. The compilers'
    stderr, with ptxas' register and spill report, is kept beside the
    library as ``<name>.log``. Raises with nvcc's stderr if the build
    fails. ``defines`` (``-DNAME=value`` flags) build a diagnostic variant
    of the library beside it; the wrappers always take the plain one."""
    so = library_path(defines)
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            nvcc = _nvcc()
            procs = []
            for src in sorted(CSRC.glob("*.cu")):
                obj = os.path.join(tmp, src.stem + ".o")
                procs.append((obj, subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, *defines, "-c", "-o", obj, str(src)],
                    stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                    text=True)))
            logs = [(obj, p.communicate()[1], p.returncode)
                    for obj, p in procs]
            lib_tmp = os.path.join(tmp, so.name)
            link = subprocess.run([nvcc, "-shared", "-o", lib_tmp,
                                   *[obj for obj, _, _ in logs]],
                                  capture_output=True, text=True)
            log = "".join(err for _, err, _ in logs) + link.stderr
            if any(rc for _, _, rc in logs) or link.returncode:
                raise RuntimeError(f"nvcc failed:\n{log}")
            so.with_suffix(".log").write_text(log)
            os.replace(lib_tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.aq_error_string.argtypes = [ctypes.c_int]
    lib.aq_error_string.restype = ctypes.c_char_p
    lib.aq_seg_cumsum_i64_tile_rows.restype = ctypes.c_int
    lib.aq_seg_scan_multi_tile_rows.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.aq_seg_scan_multi_tile_rows.restype = ctypes.c_int
    lib.aq_seg_cumsum_i64.argtypes = [_vp, _vp, _vp, _vp, _vp,
                                      ctypes.c_int64, _vp]
    lib.aq_seg_cumsum_i64.restype = ctypes.c_int
    lib.aq_seg_scan_multi.argtypes = [_vp, ctypes.c_int, _vp, _vp, _vp, _vp,
                                      _vp, ctypes.c_int64, _vp]
    lib.aq_seg_scan_multi.restype = ctypes.c_int
    lib.aq_onehot_segment_sums.argtypes = [_vp, ctypes.c_int, _vp, _vp,
                                           ctypes.c_int, ctypes.c_int64, _vp,
                                           _vp]
    lib.aq_onehot_segment_sums.restype = ctypes.c_int
    lib.aq_onehot_route.argtypes = [ctypes.c_int, _vp, ctypes.c_int,
                                    ctypes.c_int64, _vp]
    lib.aq_onehot_route.restype = ctypes.c_int
    lib.aq_onehot_max_entries.restype = ctypes.c_int
    lib.aq_fused_running_stats_tile_rows.restype = ctypes.c_int
    lib.aq_fused_running_stats.argtypes = [_vp, _vp, _vp, _vp, _vp, _vp,
                                           ctypes.c_int64, _vp]
    lib.aq_fused_running_stats.restype = ctypes.c_int
    return lib


def _kernel_name(mangled: str) -> str:
    """A kernel's name in ptxas' report, the single-pass scans by their
    lanes and flags, onehot_segment_sums by its lanes and route."""
    m = re.search(r"onehot_sumsILi(\d)ELb(\d)E", mangled)
    if m:
        return (f"onehot_segment_sums {m[1]} lanes, "
                f"{'private' if m[2] == '1' else 'shared'}")
    if re.search(r"segscan_lookbackIN10aq_running8RunStatsE", mangled):
        return "fused_running_stats 3 x float32, one input"
    m = re.search(r"segscan_lookbackIN6aq_i646AddI64ELb(\d)", mangled)
    if m:
        return f"seg_cumsum_i64, flags {m[1]}"
    m = re.search(r"segscan_lookbackIN8aq_multi5MultiI([jy])Li(\d)EEELb(\d)",
                  mangled)
    if m:
        bits = 32 if m[1] == "j" else 64
        return f"seg_scan_multi {m[2]} x {bits}-bit, flags {m[3]}"
    return mangled


def ptxas_report(defines: tuple[str, ...] = ()) -> list[dict]:
    """ptxas' report from a build's log, one dict per kernel: its name,
    registers, stack frame, spill stores and loads (bytes of local memory
    a thread moves) and static shared memory (bytes)."""
    log = library_path(defines).with_suffix(".log").read_text()
    rows: list[dict] = []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            rows.append({"kernel": _kernel_name(m[1]), "smem": 0})
        elif rows:
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if m:
                rows[-1].update(stack=int(m[1]), spill_stores=int(m[2]),
                                spill_loads=int(m[3]))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                rows[-1]["registers"] = int(m[1])
            m = re.search(r"(\d+) bytes smem", line)
            if m:
                rows[-1]["smem"] = int(m[1])
    return rows


def _check(lib: ctypes.CDLL, name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.aq_error_string(rc).decode()} ({rc})")


def _check_flags(flags: torch.Tensor | None, like: torch.Tensor) -> None:
    if flags is None:
        return
    if flags.dtype != torch.bool or flags.shape != like.shape:
        raise ValueError(f"flags must be bool of shape {tuple(like.shape)}, "
                         f"got {flags.dtype} {tuple(flags.shape)}")
    if flags.device != like.device or not flags.is_contiguous():
        raise ValueError("flags must be contiguous and on the values' device")


def _check_device(x: torch.Tensor, name: str) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")


# --------------------------------------------------------------------- #
# plain versions (CPU tensors, tests, and the on-card comparison)
# --------------------------------------------------------------------- #

def _segment_pos(flags: torch.Tensor | None, n: int,
                 device: torch.device) -> torch.Tensor:
    """Each row's position inside its segment (row 0 always starts one)."""
    idx = torch.arange(n, device=device)
    if flags is None:
        return idx
    start = torch.where(flags, idx, torch.zeros_like(idx))
    return idx - torch.cummax(start, 0).values


def seg_cumsum_i64_plain(flags: torch.Tensor | None,
                         x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch seg_cumsum_i64: cumsum minus the cumsum before each
    row's segment start. int64 arithmetic wraps mod 2^64 throughout, so
    the result is the kernel's exactly."""
    total = torch.cumsum(x, 0)
    if flags is None:
        return total
    start = torch.arange(x.shape[0], device=x.device) - _segment_pos(
        flags, x.shape[0], x.device)
    return total - (total[start] - x[start])


def _combine(op: str):
    return {"add": torch.add, "min": torch.minimum, "max": torch.maximum}[op]


def seg_scan_multi_plain(flags: torch.Tensor | None,
                         xs: tuple[torch.Tensor, ...],
                         ops: tuple[str, ...]) -> tuple[torch.Tensor, ...]:
    """Plain PyTorch seg_scan_multi: Hillis-Steele doubling gated on each
    row's position in its segment (log2(n) passes per lane). min/max
    propagate NaN (torch.minimum/maximum)."""
    n = xs[0].shape[0]
    pos = _segment_pos(flags, n, xs[0].device)
    outs = []
    for x, op in zip(xs, ops):
        comb = _combine(op)
        s = 1
        while s < n:
            earlier = torch.cat([x[:s], x[:-s]])      # x[i - s]; masked below
            x = torch.where(pos >= s, comb(earlier, x), x)
            s <<= 1
        outs.append(x)
    return tuple(outs)


def onehot_segment_sums_plain(code: torch.Tensor,
                              lanes: tuple[torch.Tensor, ...],
                              dp: int) -> torch.Tensor:
    """Plain PyTorch onehot_segment_sums: one int64 ``index_add_`` per lane
    (wraps mod 2^64, as the kernel does)."""
    cols = [torch.zeros(dp, dtype=torch.int64, device=code.device)
            .index_add_(0, code, x.to(torch.int64)) for x in lanes]
    return torch.stack(cols, 1)


def fused_running_stats_plain(x: torch.Tensor):
    """Plain PyTorch fused_running_stats: cumsum, cummin and cummax (min and
    max propagate NaN)."""
    return (torch.cumsum(x, 0), torch.cummin(x, 0).values,
            torch.cummax(x, 0).values)


# --------------------------------------------------------------------- #
# kernel wrappers
# --------------------------------------------------------------------- #

def _lookback_scratch(ntiles: int, k: int, like: torch.Tensor):
    """A single-pass scan's scratch on the current stream: each tile's
    published aggregate and inclusive prefix (2 · k · ntiles words of
    like's dtype, written before they are read), and the status words with
    the tile counter after them (ntiles + 1 int32, zeroed for every call so
    that no call reads another's)."""
    scratch = torch.empty(2 * k * ntiles, dtype=like.dtype, device=like.device)
    status = torch.zeros(ntiles + 1, dtype=torch.int32, device=like.device)
    return scratch, status


def seg_cumsum_i64(flags: torch.Tensor | None, x: torch.Tensor) -> torch.Tensor:
    """Inclusive segmented int64 running sum. flags True starts a segment
    (row 0 always starts one); flags None is one plain cumsum. Wraps mod
    2^64. x: contiguous 1-D int64 of any length."""
    if x.dtype != torch.int64 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError(f"seg_cumsum_i64 takes contiguous 1-D int64, got "
                         f"{x.dtype} {tuple(x.shape)}")
    _check_flags(flags, x)
    _check_device(x, "seg_cumsum_i64")
    if x.device.type == "cpu":
        return seg_cumsum_i64_plain(flags, x)
    n = x.shape[0]
    out = torch.empty_like(x)
    if n == 0:
        return out
    lib = build()
    ntiles = -(-n // lib.aq_seg_cumsum_i64_tile_rows())
    with torch.cuda.device(x.device):
        scratch, status = _lookback_scratch(ntiles, 1, x)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.aq_seg_cumsum_i64(
            None if flags is None else flags.data_ptr(), x.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), status.data_ptr(), n, stream)
    _check(lib, "seg_cumsum_i64", rc)
    LAUNCHES["seg_cumsum_i64"] += 1
    return out


def seg_scan_multi(flags: torch.Tensor | None, xs: tuple[torch.Tensor, ...],
                   ops: tuple[str, ...]) -> tuple[torch.Tensor, ...]:
    """k ≤ 4 inclusive segmented scans, lane i combined with ops[i] ('add',
    'min' or 'max'), all sharing one flag array (semantics as
    seg_cumsum_i64). Lanes: contiguous 1-D float32, int32, float64 or
    int64 of one length, device and element size (32-bit or 64-bit
    words); outputs keep each lane's dtype. Integer adds wrap, min and
    max propagate NaN."""
    xs, ops = tuple(xs), tuple(ops)
    if not 1 <= len(xs) <= _MAX_LANES or len(ops) != len(xs):
        raise ValueError(f"seg_scan_multi takes 1..{_MAX_LANES} lanes with "
                         f"one op each, got {len(xs)} lanes, {len(ops)} ops")
    x0 = xs[0]
    for x, op in zip(xs, ops):
        if (x.dtype not in _LANE_DTYPES or x.dim() != 1
                or not x.is_contiguous() or x.shape != x0.shape
                or x.device != x0.device):
            raise ValueError(f"seg_scan_multi lanes must be contiguous 1-D "
                             f"float32/int32/float64/int64 of one shape and "
                             f"device, got {x.dtype} {tuple(x.shape)} on "
                             f"{x.device}")
        if x.element_size() != x0.element_size():
            raise ValueError(f"seg_scan_multi lanes of one call share one "
                             f"word width, got {x0.dtype} and {x.dtype}")
        if op not in _OPS:
            raise ValueError(f"seg_scan_multi op must be one of {_OPS}, "
                             f"got {op!r}")
    _check_flags(flags, x0)
    _check_device(x0, "seg_scan_multi")
    if x0.device.type == "cpu":
        return seg_scan_multi_plain(flags, xs, ops)
    k, n = len(xs), x0.shape[0]
    outs = tuple(torch.empty_like(x) for x in xs)
    if n == 0:
        return outs
    lib = build()
    ntiles = -(-n // lib.aq_seg_scan_multi_tile_rows(
        k, int(x0.element_size() == 8)))
    ptrs = (_vp * k)
    x_ptrs = ptrs(*[x.data_ptr() for x in xs])
    out_ptrs = ptrs(*[o.data_ptr() for o in outs])
    codes = (ctypes.c_int * k)(*[_LANE_DTYPES.index(x.dtype) * 3
                                 + _OPS.index(op)
                                 for x, op in zip(xs, ops)])
    with torch.cuda.device(x0.device):
        scratch, status = _lookback_scratch(ntiles, k, x0)
        stream = torch.cuda.current_stream(x0.device).cuda_stream
        rc = lib.aq_seg_scan_multi(
            None if flags is None else flags.data_ptr(), k, x_ptrs, out_ptrs,
            codes, scratch.data_ptr(), status.data_ptr(), n, stream)
    _check(lib, "seg_scan_multi", rc)
    LAUNCHES["seg_scan_multi"] += 1
    return outs


def onehot_segment_sums(code: torch.Tensor, lanes: tuple[torch.Tensor, ...],
                        dp: int) -> torch.Tensor:
    """Exact per-slot sums: out[s, j] = sum of lanes[j] over the rows whose
    code is s, as int64 [dp, k], wrapping mod 2^64. code: contiguous 1-D
    int32 in [0, dp) (on the card a row outside that range is dropped).
    lanes: k ≤ 8 contiguous 1-D int64, int32 or bool tensors of code's
    length and device, widened to int64 as they are added. Raises
    ValueError for a dp · k whose accumulators do not fit a block's shared
    memory, on every device."""
    lanes = tuple(lanes)
    k = len(lanes)
    if (code.dtype != torch.int32 or code.dim() != 1
            or not code.is_contiguous()):
        raise ValueError(f"onehot_segment_sums takes contiguous 1-D int32 "
                         f"codes, got {code.dtype} {tuple(code.shape)}")
    if not 1 <= k <= ONEHOT_MAX_LANES:
        raise ValueError(f"onehot_segment_sums takes 1..{ONEHOT_MAX_LANES} "
                         f"lanes, got {k}")
    for x in lanes:
        if (x.dtype not in ONEHOT_DTYPES or x.shape != code.shape
                or not x.is_contiguous() or x.device != code.device):
            raise ValueError(f"onehot_segment_sums lanes must be contiguous "
                             f"1-D int64/int32/bool of the codes' shape and "
                             f"device, got {x.dtype} {tuple(x.shape)} on "
                             f"{x.device}")
    if dp < 1 or dp * k > ONEHOT_MAX_ENTRIES:
        raise ValueError(f"onehot_segment_sums: {dp} slots x {k} lanes do "
                         f"not fit one block's shared memory (at most "
                         f"{ONEHOT_MAX_ENTRIES} entries)")
    _check_device(code, "onehot_segment_sums")
    if code.device.type == "cpu":
        return onehot_segment_sums_plain(code, lanes, dp)
    out = torch.zeros((dp, k), dtype=torch.int64, device=code.device)
    n = code.shape[0]
    if n == 0:
        return out
    lib = build()
    x_ptrs = (_vp * k)(*[x.data_ptr() for x in lanes])
    dtypes = (ctypes.c_int * k)(*[ONEHOT_DTYPES.index(x.dtype)
                                  for x in lanes])
    with torch.cuda.device(code.device):
        stream = torch.cuda.current_stream(code.device).cuda_stream
        rc = lib.aq_onehot_segment_sums(code.data_ptr(), k, x_ptrs, dtypes,
                                        dp, n, out.data_ptr(), stream)
    _check(lib, "onehot_segment_sums", rc)
    LAUNCHES["onehot_segment_sums"] += 1
    return out


def onehot_route(dp: int, dtypes: tuple[torch.dtype, ...],
                 n: int) -> dict[str, int]:
    """The launch onehot_segment_sums makes on the card for dp slots, lanes
    of these dtypes and n rows: private (1: one copy of the accumulators
    per thread, plain adds) or shared (0: copies shared by a warp, shared
    atomics), copies per block, threads, blocks, tile rows, dynamic shared
    memory per block, blocks an SM holds and one stage buffer's bytes."""
    lib = build()
    k = len(dtypes)
    codes = (ctypes.c_int * k)(*[ONEHOT_DTYPES.index(d) for d in dtypes])
    info = (ctypes.c_int * len(ONEHOT_ROUTE_KEYS))()
    _check(lib, "onehot_route", lib.aq_onehot_route(k, codes, dp, n, info))
    return dict(zip(ONEHOT_ROUTE_KEYS, info))


def fused_running_stats(x: torch.Tensor):
    """Running (sums, mins, maxs) of a 1-D column in one scan, each float32
    of x's length; x is taken as float32, as in the JAX package. min and
    max propagate NaN. Any length and alignment (the TPU kernel's multiple
    of 8192 was its tile). On the card the sums are not bit-reproducible
    from run to run; min, max and integer-valued sums are exact."""
    if x.dim() != 1:
        raise ValueError(f"fused_running_stats takes a 1-D column, got "
                         f"{tuple(x.shape)}")
    _check_device(x, "fused_running_stats")
    x = x.to(torch.float32).contiguous()
    if x.device.type == "cpu":
        return fused_running_stats_plain(x)
    n = x.shape[0]
    outs = tuple(torch.empty_like(x) for _ in range(3))
    if n == 0:
        return outs
    lib = build()
    ntiles = -(-n // lib.aq_fused_running_stats_tile_rows())
    with torch.cuda.device(x.device):
        scratch, status = _lookback_scratch(ntiles, 3, x)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.aq_fused_running_stats(
            x.data_ptr(), *[o.data_ptr() for o in outs], scratch.data_ptr(),
            status.data_ptr(), n, stream)
    _check(lib, "fused_running_stats", rc)
    LAUNCHES["fused_running_stats"] += 1
    return outs


def best_profit(x: torch.Tensor, n: int) -> torch.Tensor:
    """max(x − mins(x)) over the first n rows, as a float32 scalar tensor,
    through one fused_running_stats (``pallas_kernels.best_profit``)."""
    xf = x.to(torch.float32)
    _sums, mins, _maxs = fused_running_stats(xf)
    idx = torch.arange(xf.shape[0], device=xf.device)
    return torch.where(idx < n, xf - mins, float("-inf")).max()
