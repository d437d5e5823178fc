"""Rego lexer.

Produces a token stream with explicit NEWLINE tokens: Rego rule and
comprehension bodies separate literals by newline or `;`, while newlines
inside parenthesized/bracketed terms are insignificant — the parser decides
which applies (see parser.py).
"""

from __future__ import annotations

from dataclasses import dataclass


class ScanError(SyntaxError):
    pass


@dataclass(frozen=True)
class Token:
    kind: str  # IDENT NUMBER STRING OP NEWLINE EOF
    value: object
    line: int
    col: int

    def __repr__(self):
        return f"{self.kind}({self.value!r})@{self.line}"


_TWO_CHAR = {":=", "==", "!=", "<=", ">="}
_ONE_CHAR = set("=<>+-*/%&|(){}[],:;.")

_ESCAPES = {
    '"': '"',
    "\\": "\\",
    "/": "/",
    "n": "\n",
    "t": "\t",
    "r": "\r",
    "b": "\b",
    "f": "\f",
}


def scan(src: str, name: str = "<rego>") -> list[Token]:
    toks: list[Token] = []
    i, line, col = 0, 1, 1
    n = len(src)

    def emit(kind, value, l, c):
        toks.append(Token(kind, value, l, c))

    while i < n:
        ch = src[i]
        if ch == "\n":
            if toks and toks[-1].kind not in ("NEWLINE",):
                emit("NEWLINE", None, line, col)
            i += 1
            line += 1
            col = 1
            continue
        if ch in " \t\r":
            i += 1
            col += 1
            continue
        if ch == "#":
            while i < n and src[i] != "\n":
                i += 1
            continue
        if ch == '"':
            l0, c0 = line, col
            i += 1
            col += 1
            buf = []
            while True:
                if i >= n:
                    raise ScanError(f"{name}:{l0}: unterminated string")
                c = src[i]
                if c == '"':
                    i += 1
                    col += 1
                    break
                if c == "\\":
                    if i + 1 >= n:
                        raise ScanError(f"{name}:{line}: bad escape")
                    e = src[i + 1]
                    if e == "u":
                        buf.append(chr(int(src[i + 2 : i + 6], 16)))
                        i += 6
                        col += 6
                        continue
                    if e not in _ESCAPES:
                        raise ScanError(f"{name}:{line}: bad escape \\{e}")
                    buf.append(_ESCAPES[e])
                    i += 2
                    col += 2
                    continue
                if c == "\n":
                    raise ScanError(f"{name}:{l0}: newline in string")
                buf.append(c)
                i += 1
                col += 1
            emit("STRING", "".join(buf), l0, c0)
            continue
        if ch == "`":  # raw string
            l0, c0 = line, col
            j = src.find("`", i + 1)
            if j < 0:
                raise ScanError(f"{name}:{l0}: unterminated raw string")
            raw = src[i + 1 : j]
            line += raw.count("\n")
            i = j + 1
            emit("STRING", raw, l0, c0)
            continue
        if ch.isdigit() or (ch == "." and i + 1 < n and src[i + 1].isdigit()):
            l0, c0 = line, col
            j = i
            while j < n and (src[j].isdigit() or src[j] in ".eE+-"):
                # stop at '.' followed by non-digit (ref dot), and at +/-
                # not preceded by e/E (binary operators)
                if src[j] == "." and not (j + 1 < n and src[j + 1].isdigit()):
                    break
                if src[j] in "+-" and src[j - 1] not in "eE":
                    break
                j += 1
            text = src[i:j]
            try:
                val = int(text)
            except ValueError:
                val = float(text)
            emit("NUMBER", val, l0, c0)
            col += j - i
            i = j
            continue
        if ch.isalpha() or ch == "_":
            l0, c0 = line, col
            j = i
            while j < n and (src[j].isalnum() or src[j] == "_"):
                j += 1
            emit("IDENT", src[i:j], l0, c0)
            col += j - i
            i = j
            continue
        two = src[i : i + 2]
        if two in _TWO_CHAR:
            emit("OP", two, line, col)
            i += 2
            col += 2
            continue
        if ch in _ONE_CHAR:
            emit("OP", ch, line, col)
            i += 1
            col += 1
            continue
        raise ScanError(f"{name}:{line}:{col}: unexpected character {ch!r}")

    emit("EOF", None, line, col)
    return toks
