"""Tokenizer for the AQuery dialect.

Handles: case-insensitive keywords, identifiers, int/float literals,
single/double-quoted strings, operators (incl. :=, ->, <=, >=, <>, !=,
+=, -=, *=, /=), comments (`--` and `/* */`; `/*<k>...</k>*/` tags are
comments too), and raw `<sql> ... </sql>` passthrough regions
(reference keywords.py:246-247).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Token:
    kind: str      # 'ident','int','float','string','op','sqlblock','eof'
    text: str
    pos: int       # char offset, for error messages
    line: int


class LexError(Exception):
    pass


_TWO_CHAR = (":=", "->", "<=", ">=", "<>", "!=", "==", "+=", "-=", "*=", "/=", "||")
_ONE_CHAR = "+-*/%(),.;<>=[]{}:!"


class Lexer:
    def __init__(self, text: str) -> None:
        self.text = text
        self.n = len(text)
        self.i = 0
        self.line = 1

    def error(self, msg: str) -> LexError:
        return LexError(f"line {self.line}: {msg}")

    def _peek(self, k: int = 0) -> str:
        j = self.i + k
        return self.text[j] if j < self.n else ""

    def tokens(self) -> list[Token]:
        out: list[Token] = []
        while True:
            t = self.next_token()
            out.append(t)
            if t.kind == "eof":
                return out

    def _skip_ws_comments(self) -> None:
        while self.i < self.n:
            c = self.text[self.i]
            if c == "\n":
                self.line += 1
                self.i += 1
            elif c.isspace():
                self.i += 1
            elif c == "-" and self._peek(1) == "-":
                while self.i < self.n and self.text[self.i] != "\n":
                    self.i += 1
            elif c == "/" and self._peek(1) == "*":
                j = self.text.find("*/", self.i + 2)
                if j < 0:
                    raise self.error("unterminated block comment")
                self.line += self.text.count("\n", self.i, j)
                self.i = j + 2
            else:
                return

    def next_token(self) -> Token:
        self._skip_ws_comments()
        if self.i >= self.n:
            return Token("eof", "", self.i, self.line)
        start, line = self.i, self.line
        c = self.text[self.i]

        # <sql> ... </sql> raw block
        if c == "<" and self.text[self.i: self.i + 5].lower() == "<sql>":
            j = self.text.lower().find("</sql>", self.i + 5)
            if j < 0:
                raise self.error("unterminated <sql> block")
            inner = self.text[self.i + 5: j]
            self.line += self.text.count("\n", self.i, j)
            self.i = j + 6
            return Token("sqlblock", inner, start, line)

        if c.isdigit() or (c == "." and self._peek(1).isdigit()):
            return self._number(start, line)
        if c.isalpha() or c == "_":
            j = self.i
            while j < self.n and (self.text[j].isalnum() or self.text[j] == "_"):
                j += 1
            word = self.text[self.i: j]
            self.i = j
            return Token("ident", word, start, line)
        if c in ("'", '"'):
            return self._string(c, start, line)

        two = self.text[self.i: self.i + 2]
        if two in _TWO_CHAR:
            self.i += 2
            return Token("op", two, start, line)
        if c in _ONE_CHAR:
            self.i += 1
            return Token("op", c, start, line)
        raise self.error(f"unexpected character {c!r}")

    def _number(self, start: int, line: int) -> Token:
        j = self.i
        isfloat = False
        while j < self.n and self.text[j].isdigit():
            j += 1
        if j < self.n and self.text[j] == ".":
            # "1." and "1.5" are floats, but "1 .. " etc not supported
            isfloat = True
            j += 1
            while j < self.n and self.text[j].isdigit():
                j += 1
        if j < self.n and self.text[j] in "eE":
            k = j + 1
            if k < self.n and self.text[k] in "+-":
                k += 1
            if k < self.n and self.text[k].isdigit():
                isfloat = True
                j = k
                while j < self.n and self.text[j].isdigit():
                    j += 1
        text = self.text[self.i: j]
        self.i = j
        return Token("float" if isfloat else "int", text, start, line)

    def _string(self, quote: str, start: int, line: int) -> Token:
        j = self.i + 1
        buf = []
        while j < self.n:
            c = self.text[j]
            if c == quote:
                if j + 1 < self.n and self.text[j + 1] == quote:  # '' escape
                    buf.append(quote)
                    j += 2
                    continue
                self.i = j + 1
                return Token("string", "".join(buf), start, line)
            if c == "\\" and j + 1 < self.n:
                nxt = self.text[j + 1]
                buf.append({"n": "\n", "t": "\t", "\\": "\\", quote: quote}.get(nxt, nxt))
                j += 2
                continue
            if c == "\n":
                self.line += 1
            buf.append(c)
            j += 1
        raise self.error("unterminated string literal")
