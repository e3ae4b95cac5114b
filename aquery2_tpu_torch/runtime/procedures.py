"""Stored procedures: record, replay, persist.

Counterpart of ``aquery2_tpu/runtime/procedures.py`` (the reference's
``procedure p record|stop|run|load|save|display``, server.cpp:368-502,
prompt.py:646-677). A procedure is the text of the statement batches
executed while it was recording (``Session.execute`` hands each batch to
``record``); replay executes them again in order.

The ``.aqp`` file is the JAX package's, byte for byte: one header line
``AQPROC <n>``, then the n statement batches joined by NUL, UTF-8. It
lives under ``session.resolve_path(directory)``, so a session's
``base_dir`` decides where ``stop_recording`` writes.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field


@dataclass
class StoredProcedure:
    name: str
    statements: list[str] = field(default_factory=list)


class ProcedureStore:
    def __init__(self, session, directory: str = "procedures") -> None:
        self.session = session
        self.directory = directory
        self.procedures: dict[str, StoredProcedure] = {}
        self.recording: StoredProcedure | None = None

    def start_recording(self, name: str) -> None:
        self.recording = StoredProcedure(name.lower())

    def record(self, stmt_text: str) -> None:
        if self.recording is not None:
            self.recording.statements.append(stmt_text)

    def stop_recording(self) -> None:
        """Keep the recorded procedure and write its .aqp file."""
        if self.recording is None:
            return
        self.procedures[self.recording.name] = self.recording
        self.save(self.recording.name)
        self.recording = None

    def _path(self, name: str) -> str:
        return os.path.join(self.session.resolve_path(self.directory),
                            f"{name.lower()}.aqp")

    def save(self, name: str) -> None:
        p = self.procedures[name.lower()]
        path = self._path(name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            f.write(f"AQPROC {len(p.statements)}\n")
            f.write("\0".join(p.statements))

    def load(self, name: str) -> StoredProcedure:
        """The procedure in memory, else read from its .aqp file."""
        key = name.lower()
        if key in self.procedures:
            return self.procedures[key]
        path = self._path(name)
        if not os.path.exists(path):
            raise KeyError(f"no stored procedure {name!r} (looked in {path})")
        with open(path, encoding="utf-8") as f:
            header = f.readline()
            if not header.startswith("AQPROC"):
                raise ValueError(f"{path}: not an aqp file")
            body = f.read()
        p = StoredProcedure(key, [s for s in body.split("\0") if s.strip()])
        self.procedures[key] = p
        return p

    def run(self, name: str):
        """Execute the procedure's batches in order; the last Result."""
        last = None
        for s in self.load(name).statements:
            r = self.session.execute(s)
            if r is not None:
                last = r
        return last

    def display(self, name: str) -> str:
        return "\n".join(self.load(name).statements)
