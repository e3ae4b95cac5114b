"""Multi-key sorts on the device.

Counterpart of ``aquery2_tpu/ops/sort.py`` and of the JAX package's
multi-operand ``lax.sort`` calls (the group-by tiers, the ordered path).
``lexsort`` gives one stable lexicographic order: it packs the keys' order
bits side by side into as few words of at most 63 bits as it can and sorts
the packs one after another, least significant first, each sort stable
(``plan`` gives the packs). A pack is sorted by
``kernels.radix_sort_pairs`` over the bits it uses: as a 32-bit key where
it takes 32 bits or fewer, else a 64-bit one, with a 32-bit row index
where there are fewer than 2^31 rows; an int64 key without bounds and a
float64 key sort alone, over 64 bits. On the card that is CUB's radix sort
with that end bit (csrc/radix_sort.cu); on the CPU its plain version,
``torch.sort``. DESC uses an order-reversing transform (``~x`` for
integers and bools, ``-x`` for floats), as the JAX package does.

Float keys are canonicalised first, as ``lax.sort`` does: -0.0 ties with
0.0 and every NaN sorts after +inf (in either direction, since DESC
negates first). The canonical form also keeps a radix sort on the card to
that order whatever the sign bit of a zero or a NaN.
"""

from __future__ import annotations

import torch

from aquery2_tpu_torch.ops import kernels as K

_PACK_BITS = 63          # order bits one pack holds
_I32_MIN = -(1 << 31)
_I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1


def canonical_float(x: torch.Tensor) -> torch.Tensor:
    """x with -0.0 made 0.0 and every NaN made the positive quiet NaN."""
    x = torch.where(x == 0, torch.zeros((), dtype=x.dtype, device=x.device),
                    x)
    return torch.where(x.isnan(), float("nan"), x)


def _spec(k: torch.Tensor, asc: bool, bounds):
    """(bit width, (lo, hi) integer bounds or None) of a key's field in a
    pack, or None when the key's order takes 64 bits (int64 without
    bounds, float64)."""
    if k.is_complex():
        raise TypeError(f"cannot sort dtype {k.dtype}")
    if k.dtype == torch.bool:
        return 1, None
    if k.is_floating_point():
        return None if k.dtype == torch.float64 else (32, None)
    if bounds is None:
        if k.element_size() > 4:
            return None
        info = torch.iinfo(k.dtype)
        bounds = (info.min, info.max)
    lo, hi = int(bounds[0]), int(bounds[1])
    if hi - lo > (1 << _PACK_BITS) - 1:
        return None
    return max(1, (hi - lo).bit_length()), (lo, hi)


def plan(keys):
    """lexsort's plan of keys (its entries): (each key's field, as
    ``_spec`` gives it; the packs, most significant first). A pack is (the
    keys' indices, most significant first; the route, ``u32``, ``u64`` or
    ``f64``; the end bit). Bools take 1 bit, bounded integers the bits of
    hi - lo, other keys of 32 bits or fewer 32, side by side in a pack of
    at most 63 bits, sorted as a 32-bit key (``u32``) where they take 32
    bits or fewer, else as a 64-bit one (``u64``). An int64 key without
    bounds is a ``u64`` pack of 64 bits, a float64 key an ``f64`` pack of
    64."""
    specs = [_spec(k[0], k[1], k[2] if len(k) > 2 else None) for k in keys]
    packs: list[list] = []                 # [indices, width or None]
    for i, spec in enumerate(specs):
        if (spec is not None and packs and packs[-1][1] is not None
                and packs[-1][1] + spec[0] <= _PACK_BITS):
            packs[-1][0].append(i)
            packs[-1][1] += spec[0]
        else:
            packs.append([[i], None if spec is None else spec[0]])
    return specs, [
        (ix, "u32" if width <= 32 else "u64", width) if width is not None
        else (ix, "f64" if keys[ix[0]][0].dtype == torch.float64 else "u64",
              64)
        for ix, width in packs]


def _wrap(x: int, dt: torch.dtype) -> int:
    """x modulo 2^bits of dt, as dt's signed value."""
    half = 1 << (31 if dt == torch.int32 else 63)
    return (x + half) % (2 * half) - half


def _field(k: torch.Tensor, asc: bool, spec, dt: torch.dtype):
    """A key's field as a new tensor of dt (int32 holding unsigned 32-bit
    words, or int64): ordered as the key in its direction, in [0, 2^bits)
    as an unsigned value. A bounded key's values outside its bounds take
    the nearest bound."""
    if k.dtype == torch.bool:
        one = torch.ones((), dtype=dt, device=k.device)
        zero = torch.zeros((), dtype=dt, device=k.device)
        return torch.where(k, one, zero) if asc else torch.where(k, zero, one)
    if k.is_floating_point():
        v = canonical_float((k if asc else -k).to(torch.float32))
        b = v.view(torch.int32)
        f = torch.where(b < 0, ~b, b ^ _I32_MIN)
        return f if dt == torch.int32 else f.to(dt) & 0xFFFFFFFF
    lo, hi = spec[1]
    info = torch.iinfo(k.dtype)
    v = k
    if lo > info.min or hi < info.max:
        v = v.clamp(max(lo, info.min), min(hi, info.max))
    v = v.to(dt)
    if not asc:
        return _wrap(hi, dt) - v
    lo = _wrap(lo, dt)
    return v - lo if lo or v is k else v


def _pack(keys, specs, pack, dt: torch.dtype) -> torch.Tensor:
    """The pack's fields side by side in one new tensor of dt, the most
    significant key highest."""
    s, val = sum(specs[i][0] for i in pack), None
    for i in pack:
        s -= specs[i][0]
        f = _field(keys[i][0], keys[i][1], specs[i], dt)
        if s:
            f = f << s
        val = f if val is None else val | f
    return val


def _unpack(sval: torch.Tensor, s: int, k: torch.Tensor, asc: bool, spec):
    """A bool or bounded key's values, in its dtype, from its field at
    shift s of the sorted pack."""
    bits, bounds = spec
    f = sval >> s if s else sval
    if k.dtype == torch.bool:
        f = f & 1
        return f != 0 if asc else f == 0
    if k.element_size() > sval.element_size():
        f = f.to(torch.int64) & ((1 << bits) - 1)
    elif bits < 8 * sval.element_size():
        f = f & ((1 << bits) - 1)
    lo, hi = (_wrap(b, f.dtype) for b in bounds)
    return (f + lo if asc else hi - f).to(k.dtype)


def lexsort(keys) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """Stable lexicographic sort: (int64 permutation, each key gathered by
    it). keys: [(tensor, ascending) or (tensor, ascending, (lo, hi))],
    most significant first, 1-D and of one length. Ties keep their input
    order (AQuery's insertion order within equal keys).

    (lo, hi) bounds an integer key's values; a value outside them sorts and
    comes back as the nearest bound (callers bound the rows that matter,
    e.g. the valid ones, by column stats). The packs are ``plan``'s, each
    sorted over its end bit by ``kernels.radix_sort_pairs`` with a 32-bit
    row index where n < 2^31, widened to int64 after the last pack; the
    most significant pack's bool and bounded keys come back from its
    sorted words, the other keys are gathered."""
    specs, packs = plan(keys)
    n, dev = keys[0][0].shape[0], keys[0][0].device
    perm = None
    for pack, route, end in reversed(packs):
        k, asc = keys[pack[0]][0], keys[pack[0]][1]
        if route == "f64":
            val = k
        elif specs[pack[0]] is None:            # int64 without bounds
            val = k ^ (_I64_MIN if asc else _I64_MAX)
        else:
            val = _pack(keys, specs, pack,
                        torch.int32 if route == "u32" else torch.int64)
        if perm is None:
            perm = torch.arange(n, dtype=torch.int32 if n < 1 << 31
                                else torch.int64, device=dev)
        else:
            val = val.index_select(0, perm)
        sval, perm = K.radix_sort_pairs(val.contiguous(), perm, end,
                                        route == "f64" and not asc)
        del val             # the other half, freed before the next pack
    perm = perm.to(torch.int64)

    top, shifts = packs[0][0], {}
    if specs[top[0]] is not None:
        s = sum(specs[i][0] for i in top)
        for i in top:
            s -= specs[i][0]
            shifts[i] = s
    out = []
    for i, key in enumerate(keys):
        k, asc = key[0], key[1]
        if i in shifts and (k.dtype == torch.bool or specs[i][1] is not None):
            out.append(_unpack(sval, shifts[i], k, asc, specs[i]))
        else:
            out.append(k[perm])
    return perm, out


def _pad_last(x: torch.Tensor, n: int, asc: bool) -> torch.Tensor:
    """x with the rows at or past n set to the value that sorts last in
    its direction."""
    if x.dtype == torch.bool:
        last = asc
    elif x.is_floating_point():
        last = float("inf") if asc else float("-inf")
    else:
        info = torch.iinfo(x.dtype)
        last = info.max if asc else info.min
    idx = torch.arange(x.shape[0], device=x.device)
    return torch.where(idx < n, x, last)


def sort_perm(keys: list[tuple[torch.Tensor, bool]], n: int) -> torch.Tensor:
    """Stable lexicographic sort permutation (int64).

    keys: [(key, ascending), ...] in priority order, 1-D and of one length;
    rows at or past ``n`` are padding: every key of theirs sorts last, so
    they come after the other rows, in input order."""
    return lexsort([(_pad_last(k, n, asc), asc) for k, asc in keys])[0]
