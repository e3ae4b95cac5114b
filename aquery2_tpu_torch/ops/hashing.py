"""Key packing and hashing for group-by and joins.

Counterpart of ``aquery2_tpu/ops/hashing.py``: ``dense_pack`` and
``dense_unpack`` give the perfect-hash codes of engine/groupby.py's dense
strategy; ``hash64`` (the splitmix64 finalizer), ``bits64`` and
``combine_hashes`` serve hash partitioning and row hashes.

torch has no unsigned 64-bit arithmetic on every device, so the 64-bit
hashes are computed in int64, whose wrapping add and multiply give the
same bits as uint64's, with logical right shifts; a hash comes back as the
int64 that has the uint64's bits (``.view(torch.uint64)`` or numpy's
``.view(np.uint64)`` reads it unsigned).
"""

from __future__ import annotations

import torch


def _u64(x: int) -> int:
    """The int64 with the bits of the uint64 x."""
    return x - (1 << 64) if x >= 1 << 63 else x


_SPLIT_C1 = _u64(0xBF58476D1CE4E5B9)
_SPLIT_C2 = _u64(0x94D049BB133111EB)
_GOLDEN = _u64(0x9E3779B97F4A7C15)


def dense_pack(keys: list[tuple[torch.Tensor, int, int]]
               ) -> tuple[torch.Tensor, int, list[int]]:
    """Pack integer key columns into dense codes.

    keys: [(tensor, min, max)] per key column. Returns (int64 codes,
    domain, strides) with code = Σ (k_i - min_i) · stride_i and domain =
    Π (max_i - min_i + 1); the caller checks the domain against
    config.PERFECT_HASH_MAX_DOMAIN."""
    ranges = [mx - mn + 1 for _, mn, mx in keys]
    strides: list[int] = []
    s = 1
    for r in reversed(ranges):
        strides.append(s)
        s *= r
    strides.reverse()
    code = None
    for (k, mn, _), st in zip(keys, strides):
        part = (k.to(torch.int64) - mn) * st
        code = part if code is None else code + part
    return code, s, strides


def dense_unpack(codes: torch.Tensor, keys_meta: list[tuple[int, int]],
                 strides: list[int]) -> list[torch.Tensor]:
    """Inverse of dense_pack: each column's key values from the codes.
    keys_meta: [(min, max)] per column."""
    return [(codes // st) % (mx - mn + 1) + mn
            for (mn, mx), st in zip(keys_meta, strides)]


def _shr(z: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def hash64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer of x's int64 bits (the uint64 hash's bits)."""
    z = x.to(torch.int64) + _GOLDEN
    z = (z ^ _shr(z, 30)) * _SPLIT_C1
    z = (z ^ _shr(z, 27)) * _SPLIT_C2
    return z ^ _shr(z, 31)


def bits64(x: torch.Tensor) -> torch.Tensor:
    """Lossless int64 bit view of any lane for hashing: float64 bits, the
    float32 bits sign-extended, integers and bools widened (-0.0 is the
    caller's to canonicalise where it must hash as +0.0)."""
    if x.dtype == torch.float64:
        return x.view(torch.int64)
    if x.is_floating_point():
        return x.to(torch.float32).view(torch.int32).to(torch.int64)
    return x.to(torch.int64)


def combine_hashes(hs: list[torch.Tensor]) -> torch.Tensor:
    """Order-dependent combination of per-column hashes."""
    acc = hs[0]
    for h in hs[1:]:
        acc = hash64(acc ^ (h + _GOLDEN + (acc << 6) + _shr(acc, 2)))
    return acc
