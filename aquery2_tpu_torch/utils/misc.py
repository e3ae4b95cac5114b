"""Small shared utilities.

Counterpart of the reference's ``common/utils.py`` (base62 uuids :56-64,
legal-name mangling :66-91, CaseInsensitiveDict :13-54) — re-implemented
for this engine's needs; SQL identifiers are case-insensitive in the
reference (columns declared ``id`` are queried as ``ID``, tests/q4.a).
"""

from __future__ import annotations

import itertools
import uuid as _uuid
from collections.abc import Iterator, MutableMapping
from typing import Any, TypeVar

_V = TypeVar("_V")

_B62 = "0123456789abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"


def base62uuid(length: int = 8) -> str:
    """Short unique id used to name anonymous tables/columns/kernels."""
    n = _uuid.uuid4().int
    out = []
    while n and len(out) < length:
        n, r = divmod(n, 62)
        out.append(_B62[r])
    return "".join(out) or "0"


def legal_name(name: str) -> str:
    """Mangle an arbitrary SQL identifier into a python-safe name."""
    out = [c if c.isalnum() or c == "_" else "_" for c in name]
    s = "".join(out)
    if not s or s[0].isdigit():
        s = "_" + s
    return s


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


class CaseInsensitiveDict(MutableMapping[str, _V]):
    """Dict with case-insensitive string keys that preserves insertion
    order and the original key spelling (for display)."""

    def __init__(self, data: dict[str, _V] | None = None, **kw: _V) -> None:
        self._store: dict[str, tuple[str, _V]] = {}
        if data:
            self.update(data)
        if kw:
            self.update(kw)

    @staticmethod
    def _k(key: str) -> str:
        return key.lower() if isinstance(key, str) else key

    def __setitem__(self, key: str, value: _V) -> None:
        self._store[self._k(key)] = (key, value)

    def __getitem__(self, key: str) -> _V:
        return self._store[self._k(key)][1]

    def __delitem__(self, key: str) -> None:
        del self._store[self._k(key)]

    def __iter__(self) -> Iterator[str]:
        return (orig for orig, _ in self._store.values())

    def __len__(self) -> int:
        return len(self._store)

    def __contains__(self, key: object) -> bool:
        return isinstance(key, str) and self._k(key) in self._store

    def __repr__(self) -> str:
        return f"CaseInsensitiveDict({dict(self.items())!r})"

    def copy(self) -> "CaseInsensitiveDict[_V]":
        out: CaseInsensitiveDict[_V] = CaseInsensitiveDict()
        out._store = dict(self._store)
        return out


def grouper(iterable: Any, n: int) -> Iterator[tuple]:
    it = iter(iterable)
    while chunk := tuple(itertools.islice(it, n)):
        yield chunk
