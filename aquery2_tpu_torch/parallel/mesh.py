"""The mesh: one rank per shard, and the placement of tables on it.

Counterpart of ``aquery2_tpu/parallel/mesh.py`` and of the JAX session's
``place_table``. The JAX package drives N devices from one process; the
port runs one process (rank) per shard, joined in a ``torch.distributed``
process group, and every rank issues the same statements (the SPMD
contract of parallel/multihost.py).

Placement (``place_table``) keeps on each rank only its contiguous block
of every scalar column: block r of the column's padded capacity, which
the world size divides (capacities are multiples of 1024 and worlds
powers of two), as ``shard_1d`` places it in the JAX package. The table
keeps its global row count. A placed column is a ``ShardedColumn``: its
``data`` and ``valid`` raise, so no code reads a block as if it were the
whole column. Two helpers read placed tables:

  local_view(mesh, table)  the dist tiers' view: every column's block on
                           this rank, the block's row validity and global
                           row index, and each column's global stats;
  gather_table(mesh, ...)  everything else: the columns all-gathered back
                           into a plain single-device table (counted by
                           the comm layer), as the JAX package runs
                           single-chip logic over sharded arrays.

Host decisions read global stats, so every rank takes the same plan:
placement computes each column's (min, max) and float summary over the
whole table with one all_gather of every column's block statistics, and
caches them on the column. Vector columns stay whole on every rank.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from aquery2_tpu_torch.parallel import comm
from aquery2_tpu_torch.storage.table import Column, Table


class Mesh:
    """One rank's view of the process group: its rank, the world size,
    the device its blocks live on, the group's backend and the comm
    log."""

    def __init__(self, group, rank: int, world: int,
                 device: torch.device) -> None:
        self.group = group
        self.rank = rank
        self.world = world
        self.device = torch.device(device)
        self.backend = dist.get_backend(group)
        self.log = comm.CommLog()

    def __repr__(self) -> str:
        return (f"Mesh(rank {self.rank} of {self.world}, {self.device}, "
                f"{self.backend})")


def make_mesh(world: int, device: torch.device | str) -> Mesh:
    """The mesh of the default process group, which must exist and hold
    exactly ``world`` ranks (a power of two)."""
    if world & (world - 1):
        raise ValueError("mesh size must be a power of two")
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            f"mesh={world} needs a torch.distributed process group of "
            f"{world} ranks: pass coordinator=, num_processes= and "
            "process_id= to connect(), set AQ_COORDINATOR / "
            "AQ_NUM_PROCESSES / AQ_PROCESS_ID, or launch under torchrun")
    have = dist.get_world_size()
    if have != world:
        raise RuntimeError(f"mesh={world} but the process group holds "
                           f"{have} ranks")
    return Mesh(dist.group.WORLD, dist.get_rank(), world, device)


class ShardedRead(RuntimeError):
    """A placed column was read as if its block were the whole column."""


class ShardedColumn:
    """A placed column: this rank's block, the global row count and the
    global stats. ``data`` and ``valid`` raise ShardedRead."""

    __slots__ = ("name", "sqltype", "block", "vblock", "nrows", "capacity",
                 "dictionary", "nullable", "_stats", "_fsum")
    is_vector = False

    def __init__(self, name, sqltype, block, vblock, nrows, capacity,
                 dictionary, stats, fsum) -> None:
        self.name = name
        self.sqltype = sqltype
        self.block = block
        self.vblock = vblock
        self.nrows = nrows
        self.capacity = capacity
        self.dictionary = dictionary
        self.nullable = vblock is not None
        self._stats = stats
        self._fsum = fsum

    @property
    def data(self):
        raise ShardedRead(f"column {self.name} is placed on a mesh: read "
                          "its block through parallel.mesh.local_view or "
                          "the whole column through gather_table")

    valid = data

    @property
    def device(self) -> torch.device:
        return self.block.device

    def stats(self) -> tuple[int, int]:
        """Column.stats() of the whole column (raises where it would: a
        float column's NaN or ±inf)."""
        mn, mx = self._stats
        return int(mn), int(mx)

    def float_summary(self) -> tuple[bool, float]:
        return self._fsum

    def __repr__(self) -> str:
        return f"ShardedColumn({self.name}:{self.sqltype.name}, n={self.nrows})"


class BlockColumn(Column):
    """A block of a column as the dist tiers see it: ``data`` and
    ``valid`` are this rank's rows, ``nrows`` their count, and stats()
    and float_summary() give the whole column's values."""

    __slots__ = ("_glob",)

    def stats(self):
        return self._glob.stats()

    def float_summary(self):
        return self._glob.float_summary()


def block_column(name, sqltype, data, valid, dictionary, glob) -> BlockColumn:
    """A BlockColumn over data (not padded), whose stats are glob's."""
    c = BlockColumn.__new__(BlockColumn)
    c.name = name
    c.sqltype = sqltype
    c.data = data
    c.nrows = int(data.shape[0])
    c.dictionary = dictionary
    c.valid = valid
    c._stats = None
    c._fsum = None
    c._glob = glob
    return c


class LocalView(Table):
    """This rank's rows of a table: block columns, plus
    n      the table's global row count,
    valid  [rows] bool, the block's rows that exist (and, for a joined
           buffer, that hold a pair),
    gidx   [rows] int64, each row's global position (the order of the
           whole table, for stable ties)."""

    def __init__(self, name, columns, n, valid, gidx) -> None:
        super().__init__(name)
        for c in columns:
            self.columns[c.name] = c
        self.n = n
        self.valid = valid
        self.gidx = gidx

    @property
    def nrows(self) -> int:
        return self.n


def _block_bounds(mesh: Mesh, cap: int) -> tuple[int, int]:
    if cap % mesh.world:
        raise ValueError(f"capacity {cap} is not divisible by the mesh "
                         f"size {mesh.world}")
    blk = cap // mesh.world
    return mesh.rank * blk, blk


def shard_1d(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous block of a (padded) column: a copy, so that
    the whole column can be freed."""
    lo, blk = _block_bounds(mesh, int(x.shape[0]))
    return x[lo:lo + blk].clone()


def replicated(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Rank 0's x on every rank."""
    return comm.broadcast(mesh, x, 0)


def _scalar_columns(table: Table):
    return [c for c in table.columns.values() if not c.is_vector]


def place_table(mesh: Mesh, table: Table) -> None:
    """Shard ``table`` in place: each scalar column becomes a
    ShardedColumn holding this rank's block, with global stats from one
    all_gather of every column's block statistics. Every rank must place
    the same table (the SPMD contract)."""
    cols = [c for c in _scalar_columns(table) if isinstance(c, Column)]
    if not cols or table.nrows == 0:
        return
    n = table.nrows
    blocks = []
    recs = []
    for c in cols:
        lo, blk = _block_bounds(mesh, c.capacity)
        d = shard_1d(mesh, c.data)
        v = None if c.valid is None else shard_1d(mesh, c.valid)
        rows = (torch.arange(lo, lo + blk, device=d.device) < n)
        blocks.append((d, v))
        recs.append(_block_record(d, rows if v is None else rows & v,
                                  rows & ~v if v is not None else None))
    got = comm.all_gather(mesh, torch.stack(recs)).cpu().numpy()
    for c, (d, v), rec in zip(cols, blocks, np.moveaxis(got, 1, 0)):
        stats, fsum = _combine_records(c, rec)
        table.columns[c.name] = ShardedColumn(
            c.name, c.sqltype, d, v, n, c.capacity, c.dictionary, stats,
            fsum)


_NREC = 7


def _block_record(d: torch.Tensor, ok: torch.Tensor,
                  nulls: torch.Tensor | None) -> torch.Tensor:
    """int64 [7]: (min, max) of the non-NULL rows as int64, then as
    float64 bits, then whether a non-NULL value is not finite, the
    largest finite |value| as float64 bits, and whether a row is NULL."""
    dev = d.device
    out = torch.zeros(_NREC, dtype=torch.int64, device=dev)
    if d.is_floating_point():
        f = d.to(torch.float64)
        fin = torch.isfinite(f)
        out[2] = torch.where(ok, f, float("inf")).min().view(torch.int64) \
            if f.shape[0] else _bits(float("inf"))
        out[3] = torch.where(ok, f, float("-inf")).max().view(torch.int64) \
            if f.shape[0] else _bits(float("-inf"))
        out[4] = (ok & ~fin).any().to(torch.int64)
        out[5] = torch.where(ok & fin, f.abs(), 0.0).max().view(torch.int64) \
            if f.shape[0] else 0
    else:
        i = d.to(torch.int64)
        big = torch.iinfo(d.dtype).max if d.dtype != torch.bool else 1
        small = torch.iinfo(d.dtype).min if d.dtype != torch.bool else 0
        out[0] = torch.where(ok, i, big).min() if i.shape[0] else big
        out[1] = torch.where(ok, i, small).max() if i.shape[0] else small
    if nulls is not None:
        out[6] = nulls.any().to(torch.int64)
    return out


def _bits(x: float) -> int:
    return int(np.array([x], np.float64).view(np.int64)[0])


def _combine_records(c: Column, rec: np.ndarray):
    """(stats, float summary) of the whole column from every rank's
    record, as Column.stats() and float_summary() give them."""
    if c.nrows == 0:
        return (0, 0), (True, 0.0)
    if c.data.is_floating_point():
        fmn = rec[:, 2].view(np.float64).min()
        fmx = rec[:, 3].view(np.float64).max()
        bad = bool(rec[:, 4].any())
        mag = float(rec[:, 5].view(np.float64).max())
        return (float(fmn), float(fmx)), (not bad, mag)
    mn, mx = int(rec[:, 0].min()), int(rec[:, 1].max())
    return (mn, mx), (True, float(max(abs(mn), abs(mx))))


def local_view(mesh: Mesh, table: Table) -> LocalView:
    """This rank's rows of ``table`` (placed or not: a plain column is
    sliced to the same block), with the row validity of the global row
    count and the global stats of every column."""
    if isinstance(table, LocalView):
        return table
    n = table.nrows
    cols = []
    lo = blk = None
    for c in _scalar_columns(table):
        if isinstance(c, ShardedColumn):
            d, v = c.block, c.vblock
            lo, blk = _block_bounds(mesh, c.capacity)
        else:
            lo, blk = _block_bounds(mesh, c.capacity)
            d = c.data[lo:lo + blk]
            v = None if c.valid is None else c.valid[lo:lo + blk]
        cols.append(block_column(c.name, c.sqltype, d, v, c.dictionary, c))
    if blk is None:
        raise ValueError(f"table {table.name} has no scalar column")
    dev = cols[0].data.device
    gidx = torch.arange(lo, lo + blk, dtype=torch.int64, device=dev)
    return LocalView(table.name, cols, n, gidx < n, gidx)


def is_placed(table: Table) -> bool:
    return any(isinstance(c, ShardedColumn) for c in table.columns.values())


def gather_table(mesh: Mesh, table: Table,
                 names: set[str] | None = None) -> Table:
    """The plain single-device table of a placed one: each ShardedColumn
    (of ``names``, lower case, where given; every one otherwise)
    all-gathered back into a Column. Columns left out are not in the
    result. A table that is not placed comes back as it is."""
    if not is_placed(table):
        return table
    if names is not None and not any(c.name.lower() in names
                                     for c in table.columns.values()):
        names = {next(iter(table.columns)).lower()}    # keeps the row count
    out = Table(table.name)
    for c in table.columns.values():
        if names is not None and c.name.lower() not in names:
            continue
        if not isinstance(c, ShardedColumn):
            out.add_column(c)
            continue
        lanes = [c.block] if c.vblock is None else [c.block, c.vblock]
        got = [comm.all_gather(mesh, x).reshape(-1) for x in lanes]
        col = Column(c.name, c.sqltype, got[0], nrows=c.nrows,
                     dictionary=c.dictionary,
                     valid=got[1] if len(got) > 1 else None)
        if not col.data.is_floating_point():
            col._stats = c._stats
        col._fsum = c._fsum
        out.add_column(col)
    return out
