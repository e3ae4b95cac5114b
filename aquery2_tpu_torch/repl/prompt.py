"""Interactive REPL and script runner.

Counterpart of ``aquery2_tpu/repl/prompt.py`` (the reference's
``prompt.py``, statement accumulation and command dispatch, :424-741),
with the same commands:

    <sql statements>      accumulate into the buffer
    exec | xexec | r      run the buffer
    f <file>              append a script file to the buffer
    echo <text>           print
    stats [on|off|reset]  timing statistics (reference :630-645), and the
                          process's kernel launches and onehot lanes (reset
                          clears both)
    procedure <p> <op>    record|stop|run|load|save|display (:646-677)
    save [path]           save the buffer to a file
    log <level>           info|error|silent
    sh [cmd]              shell escape (:694)
    script <file>         run a script
    dbg                   pdb over the live session
    engine [status|cpu|cuda]   the device the tables live and run on
    attach <alias> <sqlite-path|:memory:>, detach <alias>,
    backend <alias> <sql>, export <table> <alias> [target]
                          attached SQL backends (storage/datasource.py)
    exit | q | quit       quit

A file that starts with ``#!aquery`` is replayed through the REPL line by
line (reference prompt.py:602-620); any other file is executed as SQL.

``engine cpu`` / ``engine cuda`` is the port's counterpart of the JAX
package's backend switch: every column of every catalog table (and each
vector column's values and offsets) moves to the other device, and the
session's device follows, so later statements run there. Without a CUDA
card ``engine cuda`` prints the error and moves nothing.
"""

from __future__ import annotations

import os
import subprocess
import sys

import torch

from aquery2_tpu_torch.ops import kernels as K
from aquery2_tpu_torch.session import Session, connect
from aquery2_tpu_torch.storage.result import Result


class Repl:
    def __init__(self, session: Session | None = None,
                 echo_results: bool = True) -> None:
        self.session = session or connect()
        self.buffer: list[str] = []
        self.echo_results = echo_results
        self.done = False

    def handle_line(self, line: str) -> None:
        stripped = line.strip()
        if not stripped or stripped.startswith("#"):
            return                              # blank, comment, shebang
        first, _, rest = stripped.partition(" ")
        cmd = first.lower()
        db = self.session
        if cmd in ("exec", "xexec", "r", "rr"):
            self.run_buffer()
        elif cmd == "f":
            with open(db.resolve_path(rest.strip())) as fh:
                self.buffer.append(fh.read())
        elif cmd == "echo":
            print(rest)
        elif cmd == "stats":
            self._stats(rest.strip().lower())
        elif cmd == "procedure":
            self._procedure(rest.split())
        elif cmd == "save":
            with open(db.resolve_path(rest.strip() or "buffer.a"), "w") as fh:
                fh.write("\n".join(self.buffer))
        elif cmd == "log":
            db.log_level = rest.strip().lower() or "info"
        elif cmd == "sh":
            subprocess.run(rest if rest else os.environ.get("SHELL",
                                                            "/bin/sh"),
                           shell=bool(rest))
        elif cmd == "script":
            self.run_script_file(rest.strip())
        elif cmd == "dbg":
            import pdb

            session = db  # noqa: F841 (for the debugger's user)
            pdb.set_trace()
        elif cmd == "engine":
            self._engine(rest.strip().lower())
        elif cmd == "attach":
            parts = rest.split()
            if len(parts) != 2:
                print("usage: attach <alias> <sqlite-path|:memory:>")
            else:
                db.attach(parts[0], parts[1])
                print(f"attached {parts[0]} (SQLite)")
        elif cmd == "detach":
            db.detach(rest.strip())
        elif cmd == "backend":
            alias, _, sql = rest.partition(" ")
            try:
                t = db.backend_exec(alias, sql.strip())
            except Exception as e:          # noqa: BLE001 — the REPL surface
                print(f"error: {e}")
            else:
                if t is not None:
                    print(Result(t).format())
        elif cmd == "export":
            parts = rest.split()
            if len(parts) < 2:
                print("usage: export <table> <alias> [target]")
            else:
                db.backend_append(parts[1], parts[0],
                                  parts[2] if len(parts) > 2 else None)
        elif cmd in ("exit", "q", "quit"):
            self.done = True
        elif cmd == "help":
            print(__doc__)
        else:
            self.buffer.append(line)

    def run_buffer(self) -> None:
        if not self.buffer:
            return
        text = "\n".join(self.buffer)
        self.buffer.clear()
        try:
            r = self.session.execute(text)
            if r is not None and self.echo_results:
                print(r.format(limit=100))
        except Exception as e:
            self.session.log_error(str(e))

    # -- sub-commands ------------------------------------------------------

    def _engine(self, want: str) -> None:
        db = self.session
        if want in ("", "status"):
            print(f"engine: torch device = {db.device}")
        elif want in ("cpu", "cuda"):
            try:
                n = move_catalog(db, torch.device(want))
            except Exception as e:          # noqa: BLE001 — the REPL surface
                print(f"engine: cannot switch to {want!r} ({e})")
            else:
                print(f"engine: switched to {db.device} ({n} tables moved)")
        else:
            print(f"engine: unknown device {want!r} (cpu|cuda|status)")

    def _stats(self, arg: str) -> None:
        st = self.session.stats
        if arg == "on":
            st.enabled = True
        elif arg == "off":
            st.enabled = False
        elif arg == "reset":
            st.reset()
            for counts in (K.LAUNCHES, K.ONEHOT_LANES, K.ONEHOT_FORMS,
                           K.SORT_PACKS):
                counts.update(dict.fromkeys(counts, 0))
        else:
            print(st.format())
            for title, counts in (("Kernel launches:  ", K.LAUNCHES),
                                  ("Onehot lanes:     ", K.ONEHOT_LANES),
                                  ("Onehot forms:     ", K.ONEHOT_FORMS),
                                  ("Sort packs:       ", K.SORT_PACKS)):
                if any(counts.values()):
                    print(title + ", ".join(
                        f"{k}={v}" for k, v in counts.items() if v))

    def _procedure(self, args: list[str]) -> None:
        if len(args) != 2:
            print("usage: procedure <name> <record|stop|run|load|save|display>")
            return
        name, op = args[0], args[1].lower()
        ps = self.session.procedures
        try:
            if op == "record":
                ps.start_recording(name)
            elif op == "stop":
                ps.stop_recording()
            elif op == "run":
                r = ps.run(name)
                if r is not None and self.echo_results:
                    print(r.format(limit=100))
            elif op == "load":
                ps.load(name)
            elif op == "save":
                ps.save(name)
            elif op == "display":
                print(ps.display(name))
            else:
                print(f"unknown procedure op {op!r}")
        except Exception as e:
            self.session.log_error(str(e))

    # -- scripts and the loop ----------------------------------------------

    def run_script_file(self, path: str) -> None:
        with open(self.session.resolve_path(path)) as fh:
            text = fh.read()
        if text.lstrip().startswith("#!aquery"):
            for line in text.splitlines():
                self.handle_line(line)
                if self.done:
                    return
        else:
            self.buffer.append(text)
            self.run_buffer()

    def loop(self) -> None:
        from aquery2_tpu_torch import __version__

        print(f"aquery2_tpu_torch {__version__} on {self.session.device}: "
              f"type statements, then `exec`; `help` for commands")
        while not self.done:
            try:
                line = input(">>> " if not self.buffer else "... ")
            except EOFError:
                break
            except KeyboardInterrupt:
                self.buffer.clear()
                print("^C (buffer cleared)")
                continue
            self.handle_line(line)


def move_catalog(session: Session, device: torch.device) -> int:
    """Move every catalog table's tensors to ``device`` and make it the
    session's device; the tables moved. Raises, moving nothing, if the
    device is not available or the session is a mesh's (its ranks' blocks
    stay where the ranks placed them)."""
    if session.mesh is not None:
        raise RuntimeError("a mesh session's tables stay on its ranks' "
                           "devices")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available")
        device = torch.device("cuda", torch.cuda.current_device()
                              if device.index is None else device.index)
    names = session.catalog.names()
    moved = []                  # (column, slot, tensor on device), all first
    for name in names:
        for c in session.catalog.get(name).columns.values():
            slots = ("values", "offsets") if c.is_vector else ("data",
                                                                "valid")
            moved += [(c, s, getattr(c, s).to(device)) for s in slots
                      if getattr(c, s) is not None]
    for c, s, t in moved:
        setattr(c, s, t)
    session.device = device
    return len(names)


def main(argv: list[str] | None = None) -> int:
    """``python -m aquery2_tpu_torch [script | -c "sql"]``; the session
    runs on the CUDA card (``--device cpu`` before the rest for the CPU)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    device = "cuda"
    if argv[:1] == ["--device"] and len(argv) > 1:
        device, argv = argv[1], argv[2:]
    repl = Repl(connect(device=device))
    try:
        if argv and argv[0] == "-c":
            r = repl.session.execute(" ".join(argv[1:]))
            if r is not None:
                print(r.format(limit=100))
        elif argv:
            repl.run_script_file(argv[0])
        else:
            repl.loop()
    finally:
        repl.session.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
