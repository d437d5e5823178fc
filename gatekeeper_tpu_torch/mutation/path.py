"""Location-path parser for mutator `spec.location`.

Counterpart of the reference's mutation path parser
(pkg/mutation/path/parser): a dotted path whose segments are object
fields or keyed list accessors, e.g.

    spec.containers[name: *].imagePullPolicy
    spec.template.spec.tolerations
    metadata.labels."corp.example/team"

Grammar:

    path     := segment ("." segment)*
    segment  := field listSpec?
    field    := IDENT | STRING
    listSpec := "[" field ":" (field | "*") "]"
    IDENT    := [A-Za-z0-9_-]+
    STRING   := double-quoted, backslash escapes for `"` and `\\`

A keyed list accessor names the list-typed field, the key field its
elements are keyed by, and either a concrete key value or the glob `*`
(match every element; globs never create elements). Paths render back
canonically via `render()` and round-trip through `parse()`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Union


class PathError(Exception):
    pass


@dataclass(frozen=True)
class ObjectNode:
    """`.field` — descend into (or terminally name) an object field."""
    name: str


@dataclass(frozen=True)
class ListNode:
    """`.field[key: value]` — `field` holds a list of objects keyed by
    `key`; `glob` selects every element (value was `*`)."""
    name: str
    key_field: str
    key_value: Union[str, int, None]
    glob: bool = False


PathNode = Union[ObjectNode, ListNode]

_IDENT_CHARS = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_-")


def _tokenize(path: str) -> list[tuple[str, str]]:
    """[(type, text)] with types IDENT, STRING, GLOB, and the literal
    punctuation '.', '[', ']', ':'."""
    toks: list[tuple[str, str]] = []
    i, n = 0, len(path)
    while i < n:
        ch = path[i]
        if ch in ".[]:":
            toks.append((ch, ch))
            i += 1
        elif ch == "*":
            toks.append(("GLOB", "*"))
            i += 1
        elif ch == '"':
            j = i + 1
            out = []
            while j < n and path[j] != '"':
                if path[j] == "\\":
                    j += 1
                    if j >= n or path[j] not in ('"', "\\"):
                        raise PathError(
                            f"invalid escape in quoted field at {j}: {path!r}")
                out.append(path[j])
                j += 1
            if j >= n:
                raise PathError(f"unterminated quoted field: {path!r}")
            toks.append(("STRING", "".join(out)))
            i = j + 1
        elif ch.isspace():
            i += 1  # whitespace is insignificant (reference allows it
            # around the listSpec colon: `[name: *]`)
        elif ch in _IDENT_CHARS:
            j = i
            while j < n and path[j] in _IDENT_CHARS:
                j += 1
            toks.append(("IDENT", path[i:j]))
            i = j
        else:
            raise PathError(f"unexpected character {ch!r} at {i}: {path!r}")
    return toks


def parse(path: str) -> list[PathNode]:
    """Parse a location string into path nodes; raises PathError."""
    if not isinstance(path, str) or not path.strip():
        raise PathError("location must be a non-empty string")
    toks = _tokenize(path)
    nodes: list[PathNode] = []
    pos = 0

    def expect(*types: str) -> tuple[str, str]:
        nonlocal pos
        if pos >= len(toks):
            raise PathError(f"unexpected end of path: {path!r}")
        t, text = toks[pos]
        if t not in types:
            raise PathError(
                f"expected one of {types} at token {pos}, got {t!r}: {path!r}")
        pos += 1
        return t, text

    while True:
        _, name = expect("IDENT", "STRING")
        if pos < len(toks) and toks[pos][0] == "[":
            pos += 1
            _, key_field = expect("IDENT", "STRING")
            expect(":")
            t, key_value = expect("IDENT", "STRING", "GLOB")
            expect("]")
            if t == "GLOB":
                nodes.append(ListNode(name, key_field, None, glob=True))
            else:
                if t == "IDENT" and key_value.isdigit():
                    # bare numeric key values are integers (so
                    # [containerPort: 8080] matches the int-typed field
                    # a real Pod carries); quote to force a string
                    key_value = int(key_value)
                nodes.append(ListNode(name, key_field, key_value))
        else:
            nodes.append(ObjectNode(name))
        if pos >= len(toks):
            return nodes
        expect(".")
        if pos >= len(toks):
            raise PathError(f"trailing '.' in path: {path!r}")


def _render_field(name: str) -> str:
    if name and all(c in _IDENT_CHARS for c in name):
        return name
    return '"' + name.replace("\\", "\\\\").replace('"', '\\"') + '"'


def _render_key_value(value) -> str:
    if isinstance(value, int):
        return str(value)
    # a STRING of digits must stay quoted or it would re-parse as int
    if isinstance(value, str) and value.isdigit():
        return '"' + value + '"'
    return _render_field(str(value))


def render(nodes: list[PathNode]) -> str:
    """Canonical string form; parse(render(parse(s))) == parse(s)."""
    out = []
    for node in nodes:
        if isinstance(node, ListNode):
            value = "*" if node.glob else _render_key_value(node.key_value)
            out.append(f"{_render_field(node.name)}"
                       f"[{_render_field(node.key_field)}: {value}]")
        else:
            out.append(_render_field(node.name))
    return ".".join(out)
