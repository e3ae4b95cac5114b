"""ops/sort.lexsort's packs on the CPU: the route and end bit of each pack
(``plan``), the packed tier's word bounds at G1's key ranges, the narrow
32-bit pack against the 64-bit one, and radix_sort_pairs' plain version,
which is ``torch.sort`` over the key's bits. The card's sort is held to
that plain version in tests/test_torch_package.py (marked ``gpu``)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from aquery2_tpu_torch.engine import fused_groupby as fg
from aquery2_tpu_torch.ops import kernels as K
from aquery2_tpu_torch.ops import sort as S

N = 50


def _b():
    return torch.zeros(N, dtype=torch.bool)


def _i(dtype=torch.int32):
    return torch.zeros(N, dtype=dtype)


def _bits(b):
    return (0, (1 << b) - 1)


PLANS = {
    "bool + 8 bits": ([(_b(), True), (_i(), True, _bits(8))],
                      [([0, 1], "u32", 9)]),
    "bool + 24 bits": ([(_b(), True), (_i(), True, _bits(24))],
                       [([0, 1], "u32", 25)]),
    "bool + 30 bits": ([(_b(), True), (_i(), True, _bits(30))],
                       [([0, 1], "u32", 31)]),
    "bool + 31 bits, the last u32": ([(_b(), True), (_i(), True, _bits(31))],
                                     [([0, 1], "u32", 32)]),
    "bool + 32 bits, the first u64": (
        [(_b(), True), (_i(torch.int64), False, (-(1 << 31), (1 << 31) - 1))],
        [([0, 1], "u64", 33)]),
    "int32 unbounded": ([(_i(), False)], [([0], "u32", 32)]),
    "bool + int32 unbounded": ([(_b(), True), (_i(), True)],
                               [([0, 1], "u64", 33)]),
    "int16 and int8 unbounded": ([(_i(torch.int16), True),
                                  (_i(torch.int8), False)],
                                 [([0, 1], "u32", 24)]),
    "bool + 62 bits, the widest pack": (
        [(_b(), True), (_i(torch.int64), True, (5, 5 + (1 << 62) - 1))],
        [([0, 1], "u64", 63)]),
    "bool + 63 bits splits": (
        [(_b(), True), (_i(torch.int64), True, (-(1 << 62), (1 << 62) - 1))],
        [([0], "u32", 1), ([1], "u64", 63)]),
    "float32 alone": ([(_i(torch.float32), True)], [([0], "u32", 32)]),
    "bool + float32": ([(_b(), False), (_i(torch.float32), False)],
                       [([0, 1], "u64", 33)]),
    "float64 alone": ([(_i(torch.float64), False)], [([0], "f64", 64)]),
    "int64 unbounded alone": ([(_i(torch.int64), True)], [([0], "u64", 64)]),
    "a float64 between packs": (
        [(_b(), True), (_i(), True, _bits(9)), (_i(torch.float64), True),
         (_i(torch.float32), True)],
        [([0, 1], "u32", 10), ([2], "f64", 64), ([3], "u32", 32)]),
    "three packs": (
        [(_b(), True), (_i(), True, _bits(8)), (_i(), True, _bits(28)),
         (_i(), True, _bits(28)), (_i(torch.int64), False),
         (_i(), True, _bits(5))],
        [([0, 1, 2], "u64", 37), ([3], "u32", 28), ([4], "u64", 64),
         ([5], "u32", 5)]),
}


@pytest.mark.parametrize("case", sorted(PLANS))
def test_pack_plan_routes_and_end_bits(case):
    """Each pack's keys, route and end bit: bools 1 bit, bounded integers
    the bits of hi - lo, other keys of 32 bits or fewer 32, packs of at
    most 63 bits, a 32-bit key up to 32 bits; int64 without bounds and
    float64 alone over 64."""
    keys, want = PLANS[case]
    assert S.plan(keys)[1] == want


# G1_1e8's key ranges (id1, id2, id4, id5: 10 values; id3, id6: 1e7) and
# the lexsort packs of [validity, words] that the packed tier sorts
G1_RANGES = {"q3": [10**7], "q6": [10, 10],
             "q10": [10, 10, 10**7, 10, 10, 10**7]}
G1_PACKS = {"q3": [([0, 1], "u32", 25)], "q6": [([0, 1], "u32", 9)],
            "q10": [([0, 1, 2], "u64", 37), ([3], "u32", 28)]}


@pytest.mark.parametrize("q", sorted(G1_RANGES))
def test_packed_tier_word_bounds_at_g1(q):
    """_run_packed bounds each word by the bits _plan_words gave it, so
    q6's pack takes 9 bits and q10's 37 and 28."""
    fields, nwords = fg._plan_words(G1_RANGES[q])
    bounds = fg.word_bounds(fields, nwords)
    used = {"q3": [24], "q6": [8], "q10": [8, 28, 28]}[q]
    assert bounds == [(0, (1 << u) - 1) for u in used]
    keys = [(_b(), True)] + [(_i(), True, b) for b in bounds]
    assert S.plan(keys)[1] == G1_PACKS[q]


def _entries(rng, n):
    """Keys of every field kind, values past their bounds included."""
    f32 = np.array([-1.5, -0.0, 0.0, 2.0, np.nan, np.inf, -np.inf],
                   np.float32)
    return [
        (torch.from_numpy(rng.random(n) < 0.5), False),
        (torch.from_numpy(rng.integers(-9, 12, n).astype(np.int32)), True,
         (-7, 9)),
        (torch.from_numpy(rng.integers(2**40, 2**40 + 300, n)), False,
         (2**40, 2**40 + 255)),
        (torch.from_numpy(rng.choice(f32, n)), False),
        (torch.from_numpy(rng.integers(-2**31, 2**31, n).astype(np.int32)),
         True),
        (torch.from_numpy(rng.integers(-3, 3, n).astype(np.int16)), False,
         (-3, 2)),
    ]


@pytest.mark.parametrize("pick", [(0, 1), (2, 0), (3,), (4,), (1, 5, 2),
                                  (0, 4)])
def test_narrow_pack_equals_the_wide_pack(pick, rng):
    """A pack built in int32 words (the card's 32-bit keys) holds the low
    32 bits of the same pack built in int64, and the sorted keys read back
    from either are the same."""
    ents = [_entries(rng, 400)[i] for i in pick]
    specs = [S._spec(k[0], k[1], k[2] if len(k) > 2 else None) for k in ents]
    pack = list(range(len(ents)))
    wide = S._pack(ents, specs, pack, torch.int64)
    narrow = S._pack(ents, specs, pack, torch.int32)
    assert narrow.dtype == torch.int32
    assert torch.equal(narrow.to(torch.int64) & 0xFFFFFFFF,
                       wide & 0xFFFFFFFF)
    width = sum(s[0] for s in specs)
    if width <= 32:
        assert torch.equal(wide >> width, torch.zeros_like(wide))
        s = width
        for i, (k, spec) in enumerate(zip(ents, specs)):
            s -= spec[0]
            if k[0].dtype != torch.bool and spec[1] is None:
                continue
            a = S._unpack(narrow, s, k[0], k[1], spec)
            b = S._unpack(wide, s, k[0], k[1], spec)
            assert a.dtype == b.dtype == k[0].dtype and torch.equal(a, b)


def test_radix_sort_pairs_plain_sorts_the_low_bits_unsigned(rng):
    """The plain version orders by bits [0, end_bit) as an unsigned
    integer, stably, and moves each key whole: int32 words with the sign
    bit set sort after the others, bits above end_bit order nothing;
    float64 keys sort by their order bits."""
    k = torch.from_numpy(rng.integers(-2**31, 2**31, 5000).astype(np.int32))
    v = torch.arange(5000, dtype=torch.int32)
    for end in (1, 9, 31, 32):
        sk, sv = K.radix_sort_pairs(k.clone(), v.clone(), end)
        low = k.numpy().astype(np.int64) & ((1 << end) - 1)
        want = np.argsort(low, kind="stable")
        np.testing.assert_array_equal(sv.numpy(), want)
        np.testing.assert_array_equal(sk.numpy(), k.numpy()[want])
    w = torch.from_numpy(rng.integers(-2**63, 2**63 - 1, 5000))
    sk, sv = K.radix_sort_pairs(w.clone(), v.clone(), 64)
    want = np.argsort(w.numpy().view(np.uint64), kind="stable")
    np.testing.assert_array_equal(sv.numpy(), want)
    x = torch.tensor([2.0, -0.0, float("nan"), 0.0, -float("inf"),
                      float("inf"), -1.0, -float("nan")], dtype=torch.float64)
    for desc in (False, True):
        ob, sv = K.radix_sort_pairs(x, torch.arange(8), 64, desc)
        want = [4, 6, 1, 3, 0, 5, 2, 7] if not desc else \
            [5, 0, 1, 3, 6, 4, 2, 7]
        assert sv.tolist() == want
        assert torch.equal(ob, K.f64_order_bits(x, desc)[sv])
    before = (dict(K.LAUNCHES), dict(K.SORT_PACKS))
    S.lexsort([(x, True), (k[:8], False)])
    assert (K.LAUNCHES, K.SORT_PACKS) == before   # CPU tensors count none


@pytest.mark.parametrize("bad", ["float32 keys", "end bit", "descending",
                                 "values"])
def test_radix_sort_pairs_refuses_what_the_card_does_not_take(bad):
    k, v = torch.zeros(4, dtype=torch.int32), torch.arange(4)
    args = {"float32 keys": (k.float(), v, 32),
            "end bit": (k, v, 33),
            "descending": (k, v, 32, True),
            "values": (k, v.to(torch.int16), 32)}[bad]
    with pytest.raises(ValueError):
        K.radix_sort_pairs(*args)
