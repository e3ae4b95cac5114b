"""The REPL (prompt.py) and the client/server mode (server.py)."""

from aquery2_tpu_torch.repl.prompt import Repl, main

__all__ = ["Repl", "main"]
