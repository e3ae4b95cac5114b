"""Client/server mode.

Counterpart of ``aquery2_tpu/repl/server.py`` (the reference's IPC mode,
prompt process and engine process over shared memory, prompt.py:299-318,
server.cpp:659-693). The engine process owns the card; clients talk to it
over TCP with the JAX package's protocol:

    request:  4-byte big-endian length + UTF-8 SQL text
    response: 4-byte big-endian length + UTF-8 payload whose first byte
              is 'R' (the result as CSV with a header), 'E' (an error
              message) or 'N' (no result)

Each client has a thread; one statement runs at a time, under
``torch.cuda.device(session.device)`` as a trigger's action does.

Run a server:   python -m aquery2_tpu_torch.repl.server [host [port]]
Connect:        client = AqClient("localhost", 6787); client.execute(sql)
"""

from __future__ import annotations

import contextlib
import io
import socket
import struct
import sys
import threading
import time

import torch

from aquery2_tpu_torch.session import Session, connect

_HDR = struct.Struct(">I")
DEFAULT_PORT = 6787


def _send(conn: socket.socket, payload: bytes) -> None:
    conn.sendall(_HDR.pack(len(payload)) + payload)


def _recv_exact(conn: socket.socket, n: int) -> bytes | None:
    buf = b""
    while len(buf) < n:
        chunk = conn.recv(min(65536, n - len(buf)))
        if not chunk:
            return None
        buf += chunk
    return buf


def _recv(conn: socket.socket) -> bytes | None:
    hdr = _recv_exact(conn, 4)
    return None if hdr is None else _recv_exact(conn, _HDR.unpack(hdr)[0])


class AqServer:
    def __init__(self, host: str = "127.0.0.1", port: int = DEFAULT_PORT,
                 session: Session | None = None) -> None:
        self.session = session or connect()
        self.host = host
        self.port = port
        self._sock: socket.socket | None = None
        self._stop = threading.Event()
        self._lock = threading.Lock()       # one statement at a time

    def serve_forever(self) -> None:
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((self.host, self.port))
        s.listen(16)
        s.settimeout(0.5)
        self.port = s.getsockname()[1]
        self._sock = s
        while not self._stop.is_set():
            try:
                conn, _ = s.accept()
            except socket.timeout:
                continue
            threading.Thread(target=self._client_loop, args=(conn,),
                             daemon=True).start()
        s.close()

    def start_background(self) -> threading.Thread:
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        while self._sock is None:
            time.sleep(0.01)
        return t

    def shutdown(self) -> None:
        self._stop.set()

    def _execute(self, sql: str):
        dev = self.session.device
        with self._lock, (torch.cuda.device(dev) if dev.type == "cuda"
                          else contextlib.nullcontext()):
            return self.session.execute(sql)

    def _client_loop(self, conn: socket.socket) -> None:
        with conn:
            while True:
                msg = _recv(conn)
                if msg is None:
                    return
                try:
                    r = self._execute(msg.decode("utf-8"))
                    if r is None:
                        _send(conn, b"N")
                        continue
                    buf = io.StringIO()
                    buf.write(",".join(r.column_names()) + "\n")
                    for row in r.rows():
                        buf.write(",".join(
                            ";".join(map(str, v)) if isinstance(v, list)
                            else str(v) for v in row) + "\n")
                    _send(conn, b"R" + buf.getvalue().encode("utf-8"))
                except Exception as e:
                    _send(conn, b"E" + str(e).encode("utf-8"))


class AqClient:
    def __init__(self, host: str = "127.0.0.1", port: int = DEFAULT_PORT):
        self.conn = socket.create_connection((host, port))

    def execute(self, sql: str):
        """None (no result), {"columns": [...], "rows": [tuples of str]},
        or RuntimeError with the server's message."""
        _send(self.conn, sql.encode("utf-8"))
        resp = _recv(self.conn)
        if resp is None:
            raise ConnectionError("server closed")
        tag, payload = resp[:1], resp[1:].decode("utf-8")
        if tag == b"N":
            return None
        if tag == b"E":
            raise RuntimeError(payload)
        lines = payload.strip().splitlines()
        return {"columns": lines[0].split(",") if lines else [],
                "rows": [tuple(line.split(",")) for line in lines[1:]]}

    def close(self) -> None:
        self.conn.close()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    host = argv[0] if argv else "127.0.0.1"
    port = int(argv[1]) if len(argv) > 1 else DEFAULT_PORT
    srv = AqServer(host, port)
    print(f"aquery2_tpu_torch server on {host}:{port}, {srv.session.device}")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.session.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
