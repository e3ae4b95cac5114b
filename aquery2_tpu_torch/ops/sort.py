"""Multi-key sort permutations on the device.

Counterpart of ``aquery2_tpu/ops/sort.py``. The JAX package sorts all keys
in one multi-operand ``lax.sort``; here the same stable lexicographic order
comes from successive stable ``torch.sort`` calls, last key first. DESC
uses an order-reversing transform (``~x`` for integers and bools, ``-x``
for floats); padding rows sort last in either direction.

Float keys are canonicalised first, as ``lax.sort`` does: -0.0 ties with
0.0 and every NaN sorts after +inf. ``torch.sort`` already puts NaN last on
the CPU; the canonical form keeps a radix sort on the card to the same
order whatever the sign bit of a zero or a NaN.
"""

from __future__ import annotations

import torch


def canonical_float(x: torch.Tensor) -> torch.Tensor:
    """x with -0.0 made 0.0 and every NaN made the positive quiet NaN."""
    x = torch.where(x == 0, torch.zeros((), dtype=x.dtype, device=x.device),
                    x)
    return torch.where(x.isnan(), float("nan"), x)


def _desc_transform(x: torch.Tensor) -> torch.Tensor:
    if x.is_floating_point():
        return -x
    if x.is_complex():
        raise TypeError(f"cannot sort dtype {x.dtype} descending")
    return ~x


def _pad_last(x: torch.Tensor, n: int) -> torch.Tensor:
    if x.is_floating_point():
        big = float("inf")
    elif x.dtype == torch.bool:
        big = True
    else:
        big = torch.iinfo(x.dtype).max
    idx = torch.arange(x.shape[0], device=x.device)
    return torch.where(idx < n, x, big)


def sort_perm(keys: list[tuple[torch.Tensor, bool]], n: int) -> torch.Tensor:
    """Stable lexicographic sort permutation (int64).

    keys: [(key, ascending), ...] in priority order, 1-D and of one length;
    rows at or past ``n`` are padding and sort last."""
    perm = torch.arange(keys[0][0].shape[0], device=keys[0][0].device)
    for k, asc in reversed(keys):
        k = k if asc else _desc_transform(k)
        if k.is_floating_point():
            k = canonical_float(k)
        k = _pad_last(k, n)
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm
