"""Multi-key sorts on the device.

Counterpart of ``aquery2_tpu/ops/sort.py`` and of the JAX package's
multi-operand ``lax.sort`` calls (the group-by tiers, the ordered path).
``lexsort`` gives one stable lexicographic order: where the keys' order
bits fit 63 bits it packs them into one int64 and sorts once; otherwise it
sorts such packs one after another, least significant first, each sort
stable. DESC uses an order-reversing transform (``~x`` for integers and
bools, ``-x`` for floats), as the JAX package does.

Float keys are canonicalised first, as ``lax.sort`` does: -0.0 ties with
0.0 and every NaN sorts after +inf (in either direction, since DESC
negates first). The canonical form also keeps a radix sort on the card to
that order whatever the sign bit of a zero or a NaN.
"""

from __future__ import annotations

import torch

_PACK_BITS = 63          # order bits one non-negative int64 sort key holds


def canonical_float(x: torch.Tensor) -> torch.Tensor:
    """x with -0.0 made 0.0 and every NaN made the positive quiet NaN."""
    x = torch.where(x == 0, torch.zeros((), dtype=x.dtype, device=x.device),
                    x)
    return torch.where(x.isnan(), float("nan"), x)


def order_bits32(v: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2^32) ordered as the float32 v is ordered by
    ``canonical_float`` (-0.0 ties with 0.0, NaN last)."""
    b = canonical_float(v).view(torch.int32).to(torch.int64)
    return torch.where(b < 0, ~b, b + (1 << 31))


def _desc_transform(x: torch.Tensor) -> torch.Tensor:
    if x.is_floating_point():
        return -x
    if x.is_complex():
        raise TypeError(f"cannot sort dtype {x.dtype} descending")
    return ~x


def _field(k: torch.Tensor, asc: bool, bounds):
    """(non-negative int64 tensor ordered as the key in its direction, its
    bit width, (lo, hi) integer bounds or None), or None when the key's
    order takes 64 bits (int64 without bounds, float64)."""
    if k.dtype == torch.bool:
        return (k if asc else ~k).to(torch.int64), 1, None
    if k.is_floating_point():
        if k.dtype != torch.float32:
            return None
        return order_bits32(k if asc else -k), 32, None
    if bounds is None:
        if k.element_size() > 4:
            return None
        info = torch.iinfo(k.dtype)
        bounds = (info.min, info.max)
    lo, hi = int(bounds[0]), int(bounds[1])
    if hi - lo > (1 << _PACK_BITS) - 1:
        return None
    v = k.to(torch.int64).clamp(lo, hi)
    return (v - lo if asc else hi - v), max(1, (hi - lo).bit_length()), \
        (lo, hi)


def lexsort(keys) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """Stable lexicographic sort: (int64 permutation, each key gathered by
    it). keys: [(tensor, ascending) or (tensor, ascending, (lo, hi))],
    most significant first, 1-D and of one length. Ties keep their input
    order (AQuery's insertion order within equal keys).

    (lo, hi) bounds an integer key's values; a value outside them sorts and
    comes back as the nearest bound (callers bound the rows that matter,
    e.g. the valid ones, by column stats). Bools take 1 bit, bounded
    integers the bits of hi - lo, other 32-bit keys 32 bits; int64 keys
    without bounds and float64 keys sort alone."""
    specs = [_field(k[0], k[1], k[2] if len(k) > 2 else None) for k in keys]
    packs: list[list[int]] = []
    width = _PACK_BITS + 1
    for i, spec in enumerate(specs):
        if spec is None or width + spec[1] > _PACK_BITS:
            packs.append([i])
            width = _PACK_BITS + 1 if spec is None else spec[1]
        else:
            packs[-1].append(i)
            width += spec[1]

    perm = None
    for pack in reversed(packs):
        if specs[pack[0]] is None:
            k, asc = keys[pack[0]][0], keys[pack[0]][1]
            val = k if asc else _desc_transform(k)
            if val.is_floating_point():
                val = canonical_float(val)
            shifts = None
        else:
            shifts, s = [], sum(specs[i][1] for i in pack)
            val = None
            for i in pack:
                s -= specs[i][1]
                shifts.append(s)
                part = specs[i][0] << s if s else specs[i][0]
                val = part if val is None else val | part
        if perm is not None:
            val = val[perm]
        sval, idx = torch.sort(val, stable=True)
        perm = idx if perm is None else perm[idx]
    top = dict(zip(pack, shifts)) if shifts is not None else {}

    out = []
    for i, key in enumerate(keys):
        k, asc = key[0], key[1]
        spec = specs[i]
        if i in top and (k.dtype == torch.bool or spec[2] is not None):
            f = (sval >> top[i]) & ((1 << spec[1]) - 1)
            if k.dtype == torch.bool:
                out.append(f != 0 if asc else f == 0)
            else:
                lo, hi = spec[2]
                out.append((f + lo if asc else hi - f).to(k.dtype))
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
