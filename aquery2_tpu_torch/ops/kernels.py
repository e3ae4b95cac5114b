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
* ``onehot_segment_sums`` — per-slot sums of up to 8 lanes over a small
  slot domain, exact int64 for integer and bool lanes and float64 for
  float64 lanes (csrc/onehot_segment_sums.cu), replacing the TPU kernel
  ``pallas_kernels.onehot_segment_sums`` (``_make_onehot_kernel``) with
  its caller ``reduce._pallas_onehot_reduce``. Runs the dense tier's
  sums, its float64 sums among them. Its keyed form reads the key
  columns as they are stored and makes each row's slot, its validity,
  products of two lanes and the slot's row count in its load loop, so
  the dense tier makes none of them in passes of its own.
* ``fused_running_stats`` — running sum, min and max of a float32 column
  in one scan (csrc/fused_running_stats.cu), replacing the TPU kernel
  ``pallas_kernels.fused_running_stats`` (``_running_kernel``), with its
  ``best_profit`` wrapper. No engine caller, as in the JAX package.

Beside them, ``radix_sort_pairs`` (csrc/radix_sort.cu), which has no TPU
kernel of its own (the JAX package sorts with ``lax.sort``): CUB's stable
radix sort of (key, value) pairs over a key's low ``end_bit`` bits, the
key 32-bit where it fits, the value a 32-bit row index where n < 2^31,
float64 keys by their order bits. ops/sort.lexsort sorts each pack with it.

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
kernel launches, one per wrapper call that launched; ``ONEHOT_LANES`` the
lanes those onehot_segment_sums launches summed, by dtype (a product of
two lanes and a row count by their kind); ``ONEHOT_FORMS`` every
onehot_segment_sums call by its form, keyed or code, on any device;
``SORT_PACKS`` the radix_sort_pairs launches by key route (``u32``,
``u64``, ``f64``) and their digit passes of 8 bits (``passes``), on the
card only.

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
                            "fused_running_stats": 0,
                            "radix_sort_pairs": 0}
ONEHOT_LANES: dict[str, int] = {"int64": 0, "int32": 0, "bool": 0,
                                "float64": 0, "product": 0, "count": 0}
ONEHOT_FORMS: dict[str, int] = {"keyed": 0, "code": 0}
SORT_PACKS: dict[str, int] = {"u32": 0, "u64": 0, "f64": 0, "passes": 0}

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "aquery2_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_OPS = ("add", "min", "max")
# lane code = dtype · 3 + op; the first two are 32-bit words, the rest 64-bit
_LANE_DTYPES = (torch.float32, torch.int32, torch.float64, torch.int64)
_MAX_LANES = 4
# lane dtype codes; a key's code is its index in _ONEHOT_CODES
ONEHOT_DTYPES = (torch.int64, torch.int32, torch.bool, torch.float64)
ONEHOT_KEY_DTYPES = (torch.int64, torch.int32, torch.int16, torch.int8)
_ONEHOT_CODES = ONEHOT_DTYPES + (torch.int16, torch.int8)
ONEHOT_MAX_LANES = 8
ONEHOT_MAX_KEYS = 4
# One copy of the [dp][k] 8-byte accumulators must fit a block's shared
# memory (232,448 bytes on Hopper) beside two stage buffers of 1024 rows of
# codes and 8 int64 lanes: kMaxEntries in onehot_segment_sums.cu.
ONEHOT_MAX_ENTRIES = (232448 - 2 * (1024 * (4 + 8 * 8) + 16 * 9)) // 8
# radix_sort_pairs' key routes by the keys' dtype, and the key kind
# (csrc/radix_sort.cu's KeyKind) of each; a float64 key descending is kind 3
_SORT_ROUTES = {torch.int32: "u32", torch.int64: "u64", torch.float64: "f64"}
_SORT_KINDS = {"u32": 0, "u64": 1, "f64": 2}
_I64_MIN = -(1 << 63)
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
    _i = ctypes.c_int
    lib.aq_onehot_segment_sums.argtypes = [_i, _i, _vp, _vp, _vp, _vp, _i,
                                           _vp, _vp, _i, _vp, _vp, _i,
                                           ctypes.c_int64, _vp, _vp]
    lib.aq_onehot_segment_sums.restype = ctypes.c_int
    lib.aq_onehot_route.argtypes = [_i, _i, _i, _i, _vp, _i, _vp, _vp, _i,
                                    ctypes.c_int64, _vp]
    lib.aq_onehot_route.restype = ctypes.c_int
    lib.aq_onehot_max_entries.restype = ctypes.c_int
    lib.aq_fused_running_stats_tile_rows.restype = ctypes.c_int
    lib.aq_fused_running_stats.argtypes = [_vp, _vp, _vp, _vp, _vp, _vp,
                                           ctypes.c_int64, _vp]
    lib.aq_fused_running_stats.restype = ctypes.c_int
    lib.aq_radix_sort_temp_bytes.argtypes = [_i, _i, ctypes.c_int64, _i,
                                             ctypes.POINTER(ctypes.c_size_t)]
    lib.aq_radix_sort_temp_bytes.restype = ctypes.c_int
    lib.aq_radix_sort_pairs.argtypes = [_i, _i, _vp, _vp, _vp, _vp, _vp,
                                        ctypes.c_int64, _i, _vp,
                                        ctypes.c_size_t,
                                        ctypes.POINTER(ctypes.c_int), _vp]
    lib.aq_radix_sort_pairs.restype = ctypes.c_int
    return lib


def _kernel_name(mangled: str) -> str:
    """A kernel's name in ptxas' report, the single-pass scans by their
    lanes and flags, onehot_segment_sums by its lanes, its route, whether
    a lane is float64 and its keys (the code form's one code, or the
    keyed form's key columns)."""
    m = re.search(r"onehot_sumsILi(\d)ELb(\d)ELb(\d)ELi(\d)E", mangled)
    if m:
        return (f"onehot_segment_sums {m[1]} lanes, "
                f"{'private' if m[2] == '1' else 'shared'}"
                f"{', float64' if m[3] == '1' else ''}, "
                + ("code" if m[4] == "0"
                   else f"{m[4]} key{'s' if m[4] != '1' else ''}"))
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


def onehot_slots(code: torch.Tensor, dp: int, keys=(), mins=(0,),
                 strides=(1,), row_mask=None) -> torch.Tensor:
    """Each row's slot as onehot_segment_sums makes it, in int64: the sum
    of (key - min) * stride over code and keys (wrapping mod 2^64), and
    dp for a row that the kernel drops (row_mask False, or a slot outside
    [0, dp))."""
    slot = None
    for x, mn, st in zip((code, *keys), mins, strides):
        part = (x.to(torch.int64) - mn) * st
        slot = part if slot is None else slot + part
    keep = (slot >= 0) & (slot < dp)
    if row_mask is not None:
        keep &= row_mask
    return torch.where(keep, slot, dp)


def onehot_segment_sums_plain(code: torch.Tensor,
                              lanes: tuple[torch.Tensor, ...], dp: int, *,
                              keys=(), mins=None, strides=None,
                              row_mask=None, products=(),
                              counts=False) -> torch.Tensor:
    """Plain PyTorch onehot_segment_sums: one ``index_add_`` per column, in
    int64 (wraps mod 2^64, as the kernel does) or, for a float64 lane, in
    float64, its column's words holding the doubles. The code form
    indexes by the codes; the keyed form builds each row's slot as the
    dense tier built its codes (onehot_slots), sums over dp + 1 slots and
    cuts the last (the dropped rows). A product is the two lanes' int64
    product, the row count a column of ones."""
    slot, size = code, dp
    if mins is not None:
        slot, size = onehot_slots(code, dp, keys, mins, strides,
                                  row_mask), dp + 1
    cols = (*lanes, *(lanes[a].to(torch.int64) * lanes[b].to(torch.int64)
                      for a, b in products),
            *((torch.ones(slot.shape, dtype=torch.int64,
                          device=code.device),) if counts else ()))

    def col(x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.float64:
            return torch.zeros(size, dtype=torch.float64, device=code.device
                               ).index_add_(0, slot, x).view(torch.int64)
        return torch.zeros(size, dtype=torch.int64, device=code.device
                           ).index_add_(0, slot, x.to(torch.int64))
    return torch.stack([col(x) for x in cols], 1)[:dp]


def f64_order_bits(x: torch.Tensor, descending: bool) -> torch.Tensor:
    """The int64 words whose unsigned order is float64 x's order with -0.0
    equal to 0.0 and every NaN after +inf (x negated first where
    descending, so NaN stays last): csrc/radix_sort.cu's f64_order_bits."""
    x = -x if descending else x
    b = torch.where(x.isnan(), float("nan"), x + 0.0).view(torch.int64)
    return torch.where(b < 0, ~b, b ^ _I64_MIN)


def radix_sort_pairs_plain(keys: torch.Tensor, values: torch.Tensor,
                           end_bit: int, descending: bool = False):
    """Plain PyTorch radix_sort_pairs: one stable ``torch.sort`` of the
    keys' bits [0, end_bit) taken as an unsigned integer (float64 keys:
    of their order bits, which come back as the sorted keys)."""
    if keys.dtype == torch.float64:
        keys = f64_order_bits(keys, descending)
    if keys.dtype == torch.int32:
        order = keys.to(torch.int64) & ((1 << end_bit) - 1)
    elif end_bit < 64:
        order = keys & ((1 << end_bit) - 1)
    else:
        order = keys ^ _I64_MIN
    idx = torch.sort(order, stable=True).indices
    return keys[idx], values[idx]


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


def _onehot_lanes(nsrc: int, products, counts: bool):
    """Each output column's (source, other source) for the kernel: a
    source's sum (other -1), a product, the row count (-1, -1)."""
    a = [*range(nsrc), *(x for x, _ in products), *([-1] if counts else [])]
    b = [*[-1] * nsrc, *(y for _, y in products), *([-1] if counts else [])]
    return a, b


def _onehot_fits(dp: int, k: int, row_bytes: int, arrays: int) -> bool:
    """Whether one copy of the [dp][k] accumulators fits a block's shared
    memory beside two stage buffers of 1024 rows of these arrays (the
    kernel's plan_for at its smallest)."""
    return (dp * k <= ONEHOT_MAX_ENTRIES
            and -(-8 * dp * k // 16) * 16
            + 2 * (1024 * row_bytes + 16 * arrays) <= 232448)


def onehot_segment_sums(code: torch.Tensor, lanes: tuple[torch.Tensor, ...],
                        dp: int, *, keys: tuple[torch.Tensor, ...] = (),
                        mins: tuple[int, ...] | None = None,
                        strides: tuple[int, ...] | None = None,
                        row_mask: torch.Tensor | None = None,
                        products: tuple[tuple[int, int], ...] = (),
                        counts: bool = False) -> torch.Tensor:
    """Per-slot sums as int64 [dp, k]: out[s, j] is the sum of column j
    over the rows whose slot is s. lanes: contiguous 1-D int64, int32,
    bool or float64 tensors of code's length and device. Integer and bool
    lanes are widened to int64 and summed exactly, wrapping mod 2^64; a
    float64 lane is summed in float64, and its column holds the doubles'
    bits (read it with ``.view(torch.float64)``).

    The code form (no keywords): code is each row's slot, contiguous 1-D
    int32 in [0, dp) (on the card a row outside that range is dropped),
    and the k columns are the lanes' sums.

    The keyed form (mins given): code is the first key column as stored,
    keys the others (up to 4 in all, contiguous 1-D, of one integer
    dtype of ONEHOT_KEY_DTYPES, length and device); a row's slot is the
    sum of (key - mins[i]) * strides[i] in wrapping int64, and a row is
    dropped where its slot is outside [0, dp) or its row_mask (bool, of
    code's length) is False. The columns are the lanes' sums, then for
    each (a, b) of products the sum of lanes[a] * lanes[b] (integer or
    bool lanes, widened to int64), then, where counts, each slot's rows.

    The kernel reads every row of every tensor given, once: hand it
    columns cut to the rows wanted. Every call counts in ONEHOT_FORMS.
    Raises ValueError for k outside 1..8 or a dp · k whose accumulators
    do not fit a block's shared memory beside the staging, on every
    device."""
    lanes, keys, products = tuple(lanes), tuple(keys), tuple(products)
    keyed = mins is not None
    key_cols = (code, *keys)
    if not keyed:
        if keys or strides is not None or row_mask is not None \
                or products or counts:
            raise ValueError("onehot_segment_sums: keys, strides, row_mask, "
                             "products and counts take the keyed form "
                             "(mins)")
        mins, strides = (0,), (1,)
    want = ONEHOT_KEY_DTYPES if keyed else (torch.int32,)
    if (code.dtype not in want or code.dim() != 1
            or not code.is_contiguous()):
        raise ValueError(f"onehot_segment_sums takes contiguous 1-D "
                         f"{'integer keys' if keyed else 'int32 codes'}, "
                         f"got {code.dtype} {tuple(code.shape)}")
    if (len(key_cols) > ONEHOT_MAX_KEYS or len(mins) != len(key_cols)
            or len(strides) != len(key_cols)):
        raise ValueError(f"onehot_segment_sums takes 1..{ONEHOT_MAX_KEYS} "
                         f"keys, each with a min and a stride")
    columns = [(x, code.dtype) for x in keys]
    if row_mask is not None:
        columns.append((row_mask, torch.bool))
    for x, dtype in columns:
        if (x.dtype != dtype or x.shape != code.shape
                or not x.is_contiguous() or x.device != code.device):
            raise ValueError(f"onehot_segment_sums: keys share the first "
                             f"key's dtype, and keys and row_mask (bool) its "
                             f"shape and device, contiguous; got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    for x in lanes:
        if (x.dtype not in ONEHOT_DTYPES or x.shape != code.shape
                or not x.is_contiguous() or x.device != code.device):
            raise ValueError(f"onehot_segment_sums lanes must be contiguous "
                             f"1-D int64/int32/bool/float64 of the codes' "
                             f"shape and device, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    for pair in products:
        if (len(pair) != 2 or not all(0 <= j < len(lanes) for j in pair)
                or any(lanes[j].dtype == torch.float64 for j in pair)):
            raise ValueError(f"onehot_segment_sums: a product is two "
                             f"indices of integer or bool lanes, got {pair}")
    k = len(lanes) + len(products) + bool(counts)
    if not 1 <= k <= ONEHOT_MAX_LANES:
        raise ValueError(f"onehot_segment_sums takes 1..{ONEHOT_MAX_LANES} "
                         f"lanes, got {k}")
    row_bytes = (len(key_cols) * code.element_size()
                 + (row_mask is not None) + sum(x.element_size()
                                                for x in lanes))
    arrays = len(key_cols) + (row_mask is not None) + len(lanes)
    if dp < 1 or not _onehot_fits(dp, k, row_bytes, arrays):
        raise ValueError(f"onehot_segment_sums: {dp} slots x {k} lanes do "
                         f"not fit one block's shared memory (at most "
                         f"{ONEHOT_MAX_ENTRIES} entries, fewer beside rows "
                         f"wider than {4 + 8 * ONEHOT_MAX_LANES} bytes)")
    _check_device(code, "onehot_segment_sums")
    ONEHOT_FORMS["keyed" if keyed else "code"] += 1
    if code.device.type == "cpu":
        return onehot_segment_sums_plain(
            code, lanes, dp, keys=keys, mins=mins if keyed else None,
            strides=strides, row_mask=row_mask, products=products,
            counts=counts)
    out = torch.zeros((dp, k), dtype=torch.int64, device=code.device)
    n = code.shape[0]
    if n == 0:
        return out
    lib = build()
    lane_a, lane_b = _onehot_lanes(len(lanes), products, counts)
    ints = ctypes.c_int * k
    with torch.cuda.device(code.device):
        stream = torch.cuda.current_stream(code.device).cuda_stream
        rc = lib.aq_onehot_segment_sums(
            len(key_cols), _ONEHOT_CODES.index(code.dtype),
            (_vp * len(key_cols))(*[x.data_ptr() for x in key_cols]),
            (ctypes.c_longlong * len(mins))(*mins),
            (ctypes.c_longlong * len(strides))(*strides),
            None if row_mask is None else row_mask.data_ptr(), len(lanes),
            (_vp * len(lanes))(*[x.data_ptr() for x in lanes]),
            (ctypes.c_int * len(lanes))(*[_ONEHOT_CODES.index(x.dtype)
                                          for x in lanes]),
            k, ints(*lane_a), ints(*lane_b), dp, n, out.data_ptr(), stream)
    _check(lib, "onehot_segment_sums", rc)
    LAUNCHES["onehot_segment_sums"] += 1
    for x in lanes:
        ONEHOT_LANES[str(x.dtype).removeprefix("torch.")] += 1
    ONEHOT_LANES["product"] += len(products)
    ONEHOT_LANES["count"] += bool(counts)
    return out


def onehot_route(dp: int, dtypes: tuple[torch.dtype, ...], n: int, *,
                 keys: tuple[torch.dtype, ...] = (torch.int32,),
                 row_mask: bool = False,
                 products: tuple[tuple[int, int], ...] = (),
                 counts: bool = False) -> dict[str, int]:
    """The launch onehot_segment_sums makes on the card for dp slots, lanes
    of these dtypes (any of ``ONEHOT_DTYPES``), n rows and, for the keyed
    form, the key columns' dtypes (one of ``ONEHOT_KEY_DTYPES``, all
    alike; the code form's is one int32 code), whether a row mask is
    read, the products and the row count: private (1: one copy of the
    accumulators per thread, plain adds) or shared (0: copies shared by a
    warp, shared atomics), copies per block, threads, blocks, tile rows,
    dynamic shared memory per block, blocks an SM holds and one stage
    buffer's bytes."""
    lib = build()
    nsrc = len(dtypes)
    lane_a, lane_b = _onehot_lanes(nsrc, tuple(products), counts)
    k = len(lane_a)
    ints = ctypes.c_int * k
    codes = (ctypes.c_int * nsrc)(*[_ONEHOT_CODES.index(d) for d in dtypes])
    info = (ctypes.c_int * len(ONEHOT_ROUTE_KEYS))()
    _check(lib, "onehot_route", lib.aq_onehot_route(
        len(keys), _ONEHOT_CODES.index(keys[0]), int(row_mask), nsrc, codes,
        k, ints(*lane_a), ints(*lane_b), dp, n, info))
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


def radix_sort_pairs(keys: torch.Tensor, values: torch.Tensor, end_bit: int,
                     descending: bool = False):
    """Stable sort of (key, value) pairs by the keys' bits [0, end_bit)
    taken as an unsigned integer: (the sorted keys, the values in their
    order). Bits at and above end_bit order nothing but move with their
    key. keys: contiguous 1-D int32 (32-bit keys, end_bit 1..32), int64
    (64-bit keys, 1..64) or float64 (end_bit 64: sorted by
    ``f64_order_bits``, descending there reversing the order but for NaN,
    and those bits come back as the sorted keys, int64). values:
    contiguous 1-D int32 (fewer than 2^31 rows) or int64 of the keys'
    length and device.

    On the card the sort is CUB's DeviceRadixSort on double buffers, whose
    first halves are the int32 or int64 keys and the values given: their
    contents are overwritten, so hand it tensors it may reuse (float64
    keys are only read). A call that launches counts once in LAUNCHES
    and in SORT_PACKS by its route: every int call of n > 1 and every
    float64 call of n > 0 (its order-bits pass; CUB's digit passes,
    counted in SORT_PACKS["passes"], run where n > 1). An int call of
    n < 2 returns its inputs."""
    route = _SORT_ROUTES.get(keys.dtype)
    width = 32 if route == "u32" else 64
    if route is None or keys.dim() != 1 or not keys.is_contiguous():
        raise ValueError(f"radix_sort_pairs takes contiguous 1-D int32, "
                         f"int64 or float64 keys, got {keys.dtype} "
                         f"{tuple(keys.shape)}")
    if (values.dtype not in (torch.int32, torch.int64)
            or values.shape != keys.shape or not values.is_contiguous()
            or values.device != keys.device):
        raise ValueError(f"radix_sort_pairs values must be contiguous 1-D "
                         f"int32 or int64 of the keys' shape and device, "
                         f"got {values.dtype} {tuple(values.shape)} on "
                         f"{values.device}")
    if not 1 <= end_bit <= width or (route == "f64" and end_bit != 64):
        raise ValueError(f"radix_sort_pairs: end_bit {end_bit} for "
                         f"{keys.dtype} keys")
    if descending and route != "f64":
        raise ValueError("radix_sort_pairs: descending takes float64 keys")
    n = keys.shape[0]
    wide = values.dtype == torch.int64
    if not wide and n >= 1 << 31:
        raise ValueError(f"radix_sort_pairs: int32 values index fewer than "
                         f"2^31 rows, got {n}")
    _check_device(keys, "radix_sort_pairs")
    if keys.device.type == "cpu":
        return radix_sort_pairs_plain(keys, values, end_bit, descending)
    if n < 2 and route != "f64":
        return keys, values                # nothing to order or to compute
    lib = build()
    kind = _SORT_KINDS[route] + bool(descending)
    with torch.cuda.device(keys.device):
        x, buf = (keys, torch.empty(n, dtype=torch.int64, device=keys.device)
                  ) if route == "f64" else (None, keys)
        buf_alt, values_alt = torch.empty_like(buf), torch.empty_like(values)
        nbytes = ctypes.c_size_t()
        _check(lib, "radix_sort_pairs", lib.aq_radix_sort_temp_bytes(
            kind, int(wide), n, end_bit, ctypes.byref(nbytes)))
        temp = torch.empty(max(nbytes.value, 1), dtype=torch.uint8,
                           device=keys.device)
        selector = ctypes.c_int()
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        rc = lib.aq_radix_sort_pairs(
            kind, int(wide), None if x is None else x.data_ptr(),
            buf.data_ptr(), buf_alt.data_ptr(), values.data_ptr(),
            values_alt.data_ptr(), n, end_bit, temp.data_ptr(), nbytes.value,
            ctypes.byref(selector), stream)
    _check(lib, "radix_sort_pairs", rc)
    if n:
        LAUNCHES["radix_sort_pairs"] += 1
        SORT_PACKS[route] += 1
    if n > 1:
        SORT_PACKS["passes"] += -(-end_bit // 8)
    return (buf, values) if selector.value == 0 else (buf_alt, values_alt)
