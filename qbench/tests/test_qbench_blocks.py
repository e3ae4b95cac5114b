"""The check in blocks by a hash of the key columns (``check_blocks``):
at B blocks it reads what the whole answer reads, for a sound answer and
for faults that leave the keys alone; a fault that moves rows between
blocks reads non-zero at every B; ranks' host copies of their blocks
add up to the whole answer. On the CPU at 10,000 rows; the hash on the
card against the CPU's is marked gpu:

    python -m pytest qbench/tests/test_qbench_blocks.py -q
"""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch
from qbench_cells import SEED, small_cell
from qbench import check, control, harness

GROUPBY = "h2o_g1_1e8.groupby"
BLOCKS = [1, 2, 7]
CPU = torch.device("cpu")


def _cell(blocks: int, name: str = GROUPBY) -> harness.Cell:
    cell = small_cell(name)
    cell.workload = {**cell.workload, "check_blocks": blocks}
    return cell


@pytest.fixture(scope="module")
def program():
    prog = harness.Program(small_cell(GROUPBY), SEED, CPU)
    yield prog
    prog.close()


def _float_up(q, t):
    if q == "q3":
        c = t.columns["v3"]
        c.data = c.data.clone()
        c.data[0] *= 1 + 1e-3


def _null_flipped(q, t):
    if q == "q1":
        c = t.columns["v1"]
        c.valid = torch.ones_like(c.data, dtype=torch.bool)
        c.valid[0] = False


def _vector_swapped(q, t):
    if q == "q8":
        c = t.columns["largest2_v3"]
        i = int(torch.nonzero(c.offsets[1:c.nrows + 1]
                              - c.offsets[:c.nrows] == 2)[0])
        at = int(c.offsets[i])
        c.values = c.values.clone()
        c.values[at:at + 2] = c.values[at:at + 2].flip(0)


def _key_moved(q, t):
    if q == "q3":
        c = t.columns["id3"]
        c.data = c.data.clone()
        c.data[0] += 1


def _row_missing(q, t):
    if q == "q5":
        for c in t.columns.values():
            c.nrows -= 1


def _readings(program, blocks: int, fault=None) -> dict:
    """The checks of one mix's answers, planted with fault, at blocks."""
    cell = _cell(blocks)
    program.blocks, program.block_keys = harness.blocking(cell)
    answers = {}
    for q in cell.queries:
        t = program.run(q, True, False, False)
        if fault is not None:
            fault(q.name, t)
        answers[q.name] = program.copy_out(t, q.name)
    parts = harness.reference_parts(
        cell, SEED, CPU, answers, program.strings, program.string_format,
        harness.owned_blocks(blocks), log=lambda msg: None)
    return harness.readings(cell, parts)[0]


@pytest.mark.parametrize("fault", [None, _float_up, _null_flipped,
                                   _vector_swapped])
@pytest.mark.parametrize("blocks", BLOCKS)
def test_blocks_read_what_the_whole_answer_reads(program, blocks, fault):
    whole = _readings(program, 1, fault)
    assert _readings(program, blocks, fault) == whole
    bad = {k for k, (v, lim) in whole.items() if v > lim}
    assert bool(bad) == (fault is not None), whole


@pytest.mark.parametrize("fault", [_key_moved, _row_missing])
@pytest.mark.parametrize("blocks", BLOCKS)
def test_rows_moved_between_blocks_read_non_zero(program, blocks, fault):
    got = _readings(program, blocks, fault)
    q = "q3" if fault is _key_moved else "q5"
    assert got[f"{q}.cells"][0] > 0, got


def test_blocks_float_is_the_whole_answers_not_the_largest_ratio():
    """Two blocks: |got - want| of 1 where |want| reaches 100, and of 0.5
    where it reaches 1, read 1 / 100, as the whole answer does."""
    def block(g, w):
        return check.Answer({"k": torch.tensor([0]),
                             "f": torch.tensor([g], dtype=torch.float64)},
                            ["k"], ["f"]), \
            check.Answer({"k": torch.tensor([0]),
                          "f": torch.tensor([w], dtype=torch.float64)},
                         ["k"], ["f"])
    parts = [check.compare_parts(*block(101.0, 100.0)),
             check.compare_parts(*block(1.5, 1.0))]
    assert check.combine(parts)["float"] == 1 / 100
    assert check.combine([check.compare_parts(None, None)]) == {
        "schema": 0, "cells": 0, "float": 0.0}
    got, _ = block(1.0, 1.0)
    assert check.compare_parts(got, None)["cells"] == 2   # none expected


@pytest.mark.parametrize("query", [q.name for q in
                                   small_cell(GROUPBY).queries])
def test_block_keys_are_the_answers_keys(query):
    fn = harness.reference_fn("h2o_g1_1e8", query)
    want = fn(harness.make_tables(small_cell(GROUPBY), SEED, CPU))
    assert harness.blocking(_cell(4))[1][query] == want.keys


def test_a_query_without_block_keys_is_checked_only_whole():
    assert harness.blocking(_cell(1, "h2o_j1_1e7.join")) == (1, {})
    with pytest.raises(ValueError, match="j1_q1.*BLOCK_KEYS"):
        harness.blocking(_cell(2, "h2o_j1_1e7.join"))
    for bad in (0, "8", 2.0, check.MAX_BLOCKS + 1):
        with pytest.raises(ValueError, match="check_blocks"):
            harness.blocking(_cell(bad))


def test_ranks_host_copies_add_up_to_the_whole_answer(program):
    """Each of 4 ranks keeps the rows of its blocks (b = rank mod 4) of 8,
    each in its block; together they are the whole answer."""
    blocks, size = 8, 4
    program.blocks, program.block_keys = harness.blocking(_cell(blocks))
    try:
        for q in small_cell(GROUPBY).queries:
            table = program.run(q, True, False, False)
            keys = program.block_keys[q.name]
            pieces = {}
            for rank in range(size):
                program.world = SimpleNamespace(rank=rank, size=size,
                                                barrier=lambda: None)
                copy = program.copy_out(table, q.name)
                assert sorted(copy) == list(range(rank, blocks, size))
                pieces.update(copy)
            for b, cols in pieces.items():
                got = harness.plain_answer(cols, {}, "{}")
                assert torch.all(check.block_of(
                    [got.columns[k] for k in keys], blocks) == b)
            union = _concat([pieces[b] for b in range(blocks)])
            whole = harness.plain_answer(harness.host_copy(table), {}, "{}")
            whole.keys = keys
            assert union.nrows == whole.nrows > 0
            assert check.compare(union, whole) == {"schema": 0, "cells": 0,
                                                   "float": 0.0}
    finally:
        program.world = None


def _concat(copies: list) -> check.Answer:
    """One Answer of host copies' rows, one copy after another."""
    ans = check.Answer({})
    for i, (name, _, _, offsets, _) in enumerate(copies[0]):
        vals = torch.cat([c[i][1] for c in copies])
        ans.columns[name] = vals
        if offsets is not None:
            lens = torch.cat([c[i][3][1:] - c[i][3][:-1] for c in copies])
            ans.offsets[name] = torch.cat([torch.zeros(1, dtype=torch.int64),
                                           torch.cumsum(lens, 0)])
    return ans


def _plain_block(row: list[int], blocks: int) -> int:
    """block_of of one row in Python's integers: splitmix64's finalizer
    over unsigned 64-bit words, the sum taken as a signed int64, mod
    blocks."""
    m = (1 << 64) - 1

    def mix(h):
        h = (h ^ (h >> 30)) * 0xBF58476D1CE4E5B9 & m
        h = (h ^ (h >> 27)) * 0x94D049BB133111EB & m
        return h ^ (h >> 31)
    h = None
    for v in row:
        v &= 0xFFFFFFFF
        h = mix(((v if h is None else h ^ v) + 0x9E3779B97F4A7C15) & m)
    return (h - (1 << 64) if h >> 63 else h) % blocks


def test_block_of_is_a_fixed_hash_chunked(monkeypatch):
    g = torch.Generator().manual_seed(SEED)
    keys = [torch.randint(-2**31, 2**31 - 1, (1000,), generator=g,
                          dtype=torch.int32) for _ in range(3)]
    want = [_plain_block(list(r), 16) for r in zip(*(k.tolist()
                                                     for k in keys))]
    got = check.block_of(keys, 16)
    assert got.dtype == torch.int16 and got.tolist() == want
    monkeypatch.setattr(check, "CHUNK_ROWS", 7)
    assert check.block_of(keys, 16).tolist() == want
    assert check.block_of([k.to(torch.int64) for k in keys],
                          16).tolist() == want


def test_control_in_blocks_reads_as_whole():
    whole = control.control_checks(_cell(1), SEED, CPU)
    assert control.control_checks(_cell(7), SEED, CPU) == whole
    assert [k for k, (v, lim) in whole.items() if v > lim], whole


@pytest.mark.gpu
def test_block_of_on_the_card_is_the_cpus():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = torch.Generator().manual_seed(SEED)
    keys = [torch.randint(-2**31, 2**31 - 1, (1 << 20,), generator=g,
                          dtype=torch.int32) for _ in range(6)]
    cpu = check.block_of(keys, 16)
    card = check.block_of([k.cuda() for k in keys], 16)
    assert torch.equal(card.cpu(), cpu)
