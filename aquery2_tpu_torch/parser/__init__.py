"""AQuery-dialect SQL frontend.

Counterpart of the reference's ``aquery_parser/`` (a mo-sql-parsing fork
producing a JSON AST, aquery_parser/parser.py:36-718). This is a
from-scratch recursive-descent parser producing **typed dataclass AST
nodes** (parser.ast_nodes) instead of nested dicts — the reference's own
TODOs call for decoupling the stringly-typed layers (README.md:323).

Dialect surface covered (grammar features, with reference anchors):
  * ASSUMING ASC/DESC sort-assumption clause (parser.py:300-301,386-387)
  * FUNCTION / AGGREGATION FUNCTION bodies with :=, if/elif/else, for
    (parser.py:325-354)
  * CREATE TRIGGER ... ACTION ... [INTERVAL n | ON t WHEN q] (:574-590)
  * LOAD MODULE FROM "lib.so" FUNCTIONS (f(a:type)->ret, ...) (:662-698)
  * <sql> ... </sql> passthrough blocks (:44)
  * LOAD [COMPLEX] DATA INFILE / INTO OUTFILE (:448-460)
  * full SELECT with joins, GROUP BY expressions, ORDER BY, DISTINCT,
    INTO table, LIMIT; DDL/DML (:484-706)
"""

import threading

from aquery2_tpu_torch.parser.parser import Parser
from aquery2_tpu_torch.parser import ast_nodes as A

_lock = threading.Lock()  # the reference serializes parsing too (__init__.py:18)


def parse(text: str) -> list:
    """Parse a script / statement batch into a list of AST statements."""
    with _lock:
        return Parser(text).parse_script()


__all__ = ["parse", "Parser", "A"]
