"""Collectives of the distribution layer, each one counted.

Counterpart of ``aquery2_tpu/parallel/comm.py``. The JAX package reads the
collectives of a query out of its compiled SPMD program; here every
collective goes through one of the wrappers below, which issue it on the
mesh's process group and record its kind, count and tensor bytes in the
mesh's ``CommLog``. ``comm_stats`` and ``last_query_comm`` give the JAX
package's dict: ``{kind: {"count", "tensor_bytes"},
"wire_bytes_per_chip"}``.

Kinds and bytes (``tensor_bytes`` is the result tensor's size on this
rank, as the JAX package counts the HLO op's result):
    all_reduce   the tensor; wire 2·(n-1)/n of it (ring)
    all_gather   the gathered result (n blocks); wire (n-1)/n of it
    all_to_all   the received rows; wire the bytes sent to other ranks
                 (exact: the split sizes are known)
    broadcast    the tensor; wire the tensor

Variable-length exchanges (``all_to_all_v``, ``all_gather_v``) first trade
their row counts (one small collective, counted like any other), then move
every lane of a row together: the lanes are packed side by side as bytes
into one [rows, row bytes] tensor, so one exchange costs one data
collective whatever its lane count.

The gloo backend takes CPU tensors only. Where the group's backend is gloo
and a tensor lies on a CUDA device, ``_on_host`` stages the collective
through host memory: copy out, run, copy back. That is decided by the
backend's name, once, here; nothing else changes the device or the
backend.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

class CommLog:
    """Per-kind count and tensor bytes, and the wire model's bytes."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.kinds: dict[str, dict[str, int]] = {}
        self.wire = 0.0

    def note(self, kind: str, nbytes: int, wire: float) -> None:
        rec = self.kinds.setdefault(kind, {"count": 0, "tensor_bytes": 0})
        rec["count"] += 1
        rec["tensor_bytes"] += int(nbytes)
        self.wire += wire

    def stats(self) -> dict:
        out: dict = {k: dict(v) for k, v in self.kinds.items()}
        out["wire_bytes_per_chip"] = int(self.wire)
        return out


def comm_stats(mesh) -> dict:
    """The collectives recorded on ``mesh`` since its log was reset."""
    return mesh.log.stats()


def last_query_comm(session) -> dict | None:
    """The collectives of the session's most recent statement (the
    executor resets the log as each statement starts), or None without a
    mesh."""
    mesh = getattr(session, "mesh", None)
    if mesh is None:
        return None
    return comm_stats(mesh)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _on_host(mesh, t: torch.Tensor) -> bool:
    return mesh.backend == "gloo" and t.is_cuda


def _back(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if like.dtype == torch.bool:
        t = t != 0
    return t.to(like.device)


_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
        "max": dist.ReduceOp.MAX}
# the gather into one tensor under its newer name, where torch has it
_ALL_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def _staged(mesh, t: torch.Tensor) -> torch.Tensor:
    """t as the collective gets it: on the host under gloo, bool as
    uint8, contiguous."""
    if _on_host(mesh, t):
        t = t.cpu()
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    return t.contiguous()


def all_reduce(mesh, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """The elementwise sum, min or max of t over the ranks (a new
    tensor on t's device)."""
    w = _staged(mesh, t)
    if w is t:
        w = t.clone()
    if op == "sum" and t.dtype == torch.bool:
        raise TypeError("all_reduce sum of bool: widen it first")
    dist.all_reduce(w, op=_OPS[op], group=mesh.group)
    n = mesh.world
    mesh.log.note("all_reduce", _nbytes(w), 2.0 * (n - 1) / n * _nbytes(w))
    return _back(w, t)


def all_reduce_lanes(mesh, lanes: dict[str, torch.Tensor],
                     op: str) -> dict[str, torch.Tensor]:
    """all_reduce of several equal-length lanes: one collective per
    dtype (the lanes of a dtype stacked into one [lanes, length]
    tensor)."""
    by_dtype: dict[torch.dtype, list[str]] = {}
    for tag, v in lanes.items():
        by_dtype.setdefault(v.dtype, []).append(tag)
    out: dict[str, torch.Tensor] = {}
    for tags in by_dtype.values():
        red = all_reduce(mesh, torch.stack([lanes[t] for t in tags]), op)
        for i, t in enumerate(tags):
            out[t] = red[i]
    return out


def all_gather(mesh, t: torch.Tensor) -> torch.Tensor:
    """[world, *t.shape]: every rank's t (t of one shape on every
    rank)."""
    w = _staged(mesh, t)
    out = torch.empty((mesh.world * w.shape[0], *w.shape[1:]),
                      dtype=w.dtype, device=w.device)
    _ALL_GATHER(out, w, group=mesh.group)
    out = out.reshape(mesh.world, *w.shape)
    n = mesh.world
    mesh.log.note("all_gather", _nbytes(out), (n - 1) / n * _nbytes(out))
    return _back(out, t)


def broadcast(mesh, t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank src's t on every rank (t of one shape and dtype on every
    rank)."""
    w = _staged(mesh, t)
    if w is t:
        w = t.clone()
    dist.broadcast(w, src=src, group=mesh.group)
    mesh.log.note("broadcast", _nbytes(w), float(_nbytes(w)))
    return _back(w, t)


# --------------------------------------------------------------------- #
# variable-length exchanges: rows of several lanes packed as bytes
# --------------------------------------------------------------------- #

def _pack(lanes: list[torch.Tensor]) -> tuple[torch.Tensor, list]:
    """[rows, row bytes] uint8 of the lanes side by side, and each lane's
    (dtype, offset, width) to unpack it."""
    parts, layout, off = [], [], 0
    for x in lanes:
        x = x.contiguous()
        if x.dtype == torch.bool:
            x = x.to(torch.uint8)
            dt = torch.bool
        else:
            dt = x.dtype
        w = x.element_size()
        parts.append(x.view(torch.uint8).reshape(-1, w))
        layout.append((dt, off, w))
        off += w
    return torch.cat(parts, dim=1), layout


def _unpack(rows: torch.Tensor, layout) -> list[torch.Tensor]:
    out = []
    for dt, off, w in layout:
        raw = rows[:, off:off + w].clone(memory_format=torch.contiguous_format)
        if dt == torch.bool:
            out.append(raw.view(torch.uint8).reshape(-1) != 0)
        else:
            out.append(raw.view(dt).reshape(-1))
    return out


def all_to_all_v(mesh, dest: torch.Tensor, lanes: list[torch.Tensor]
                 ) -> list[torch.Tensor]:
    """Send row i of every lane to rank dest[i] (int64 in [0, world));
    returns the received lanes, rank 0's rows first, each sender's rows
    in its order. Two collectives: the per-destination counts, then the
    rows."""
    n = mesh.world
    dev = dest.device
    order = torch.sort(dest, stable=True).indices
    counts = torch.bincount(dest, minlength=n).to(torch.int64)
    recv_counts = _exchange_counts(mesh, counts)
    send = counts.tolist()
    recv = recv_counts.tolist()
    rows, layout = _pack([x[order] for x in lanes])
    w = _staged(mesh, rows)
    out = torch.empty((sum(recv), rows.shape[1]), dtype=torch.uint8,
                      device=w.device)
    dist.all_to_all_single(out, w, output_split_sizes=recv,
                           input_split_sizes=send, group=mesh.group)
    width = rows.shape[1]
    mesh.log.note("all_to_all", out.numel(),
                  float((sum(send) - send[mesh.rank]) * width))
    return _unpack(out.to(dev), layout)


def _exchange_counts(mesh, counts: torch.Tensor) -> torch.Tensor:
    """counts[j] = rows this rank sends to rank j → rows it receives from
    each rank (one all_to_all of world int64)."""
    w = _staged(mesh, counts)
    out = torch.empty_like(w)
    dist.all_to_all_single(out, w, group=mesh.group)
    n = mesh.world
    mesh.log.note("all_to_all", _nbytes(out),
                  float((n - 1) * out.element_size()))
    return out.to(counts.device)


def all_gather_v(mesh, lanes: list[torch.Tensor]
                 ) -> tuple[list[torch.Tensor], list[int]]:
    """Every rank's rows of the lanes (rows of one length per rank, any
    length across ranks), rank 0's first: (lanes, each rank's row count).
    Two collectives: the counts, then the rows padded to the longest."""
    dev = lanes[0].device
    m = int(lanes[0].shape[0])
    sizes = all_gather(mesh, torch.tensor([m], dtype=torch.int64,
                                          device=dev)).reshape(-1).tolist()
    top = max(sizes)
    rows, layout = _pack(lanes)
    if top > m:
        rows = torch.cat([rows, rows.new_zeros((top - m, rows.shape[1]))])
    got = all_gather(mesh, rows)                  # [world, top, bytes]
    keep = torch.cat([got[r, :sizes[r]] for r in range(mesh.world)])
    return _unpack(keep, layout), sizes
