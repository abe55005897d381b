"""Schema-free protobuf text-format parser.

The reference drives everything through protobuf text configs
(`second/protos/pipeline.proto`, parsed at `second/pytorch/train.py:115-118`). Rather
than vendoring generated `*_pb2.py` code, we parse the text format directly into a
lightweight tree and map it onto typed dataclasses (see `schema.py`). This keeps the
reference's `.config` files loadable verbatim while staying pure-Python.

Grammar handled (the subset protobuf text-format actually uses):
    message   := (field)*
    field     := IDENT ':' value | IDENT ':'? '{' message '}'
    value     := scalar | '[' scalar (',' scalar)* ']'
    scalar    := number | 'true' | 'false' | quoted string | bare identifier (enum)
Comments start with '#'. Repeated fields accumulate; scalar re-assignment follows
text-format semantics where the *last* occurrence of a singular field wins (the
reference configs rely on this, e.g. duplicate `steps:` entries).
"""

from __future__ import annotations

import re
from typing import Any, Iterator, List, Tuple, Union


class ConfigNode:
    """A parsed text-proto message: an ordered multimap of field name -> values."""

    def __init__(self) -> None:
        self._fields: dict[str, List[Any]] = {}

    # -- construction ------------------------------------------------------
    def add(self, key: str, value: Any) -> None:
        self._fields.setdefault(key, []).append(value)

    # -- access ------------------------------------------------------------
    def keys(self):
        return self._fields.keys()

    def __contains__(self, key: str) -> bool:
        return key in self._fields

    def get_all(self, key: str) -> List[Any]:
        """All occurrences of a (repeated) field."""
        return self._fields.get(key, [])

    def get(self, key: str, default: Any = None) -> Any:
        """Last occurrence of a field (text-format singular semantics)."""
        vals = self._fields.get(key)
        if not vals:
            return default
        return vals[-1]

    def child(self, *path: str) -> "ConfigNode | None":
        """Walk nested message fields; returns None if any hop is missing."""
        node: ConfigNode | None = self
        for p in path:
            if node is None:
                return None
            nxt = node.get(p)
            node = nxt if isinstance(nxt, ConfigNode) else None
        return node

    def scalar(self, *path_and_default: Any) -> Any:
        """node.scalar('a', 'b', 'field', default) — nested scalar lookup."""
        *path, last, default = path_and_default
        node = self.child(*path) if path else self
        if node is None:
            return default
        val = node.get(last, default)
        return val

    def to_dict(self) -> dict:
        out: dict[str, Any] = {}
        for k, vals in self._fields.items():
            conv = [v.to_dict() if isinstance(v, ConfigNode) else v for v in vals]
            out[k] = conv[0] if len(conv) == 1 else conv
        return out

    def __repr__(self) -> str:
        return f"ConfigNode({self.to_dict()!r})"


_TOKEN_RE = re.compile(
    r"""
    (?P<comment>\#[^\n]*)
  | (?P<string>"(?:[^"\\]|\\.)*"|'(?:[^'\\]|\\.)*')
  | (?P<punct>[{}\[\]:,])
  | (?P<atom>[^\s{}\[\]:,#]+)
    """,
    re.VERBOSE,
)


def _tokenize(text: str) -> Iterator[Tuple[str, str]]:
    for m in _TOKEN_RE.finditer(text):
        kind = m.lastgroup
        if kind == "comment":
            continue
        yield kind, m.group()


_NUM_RE = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?$")


def _convert_atom(tok: str) -> Union[int, float, bool, str]:
    if tok in ("true", "True"):
        return True
    if tok in ("false", "False"):
        return False
    if _NUM_RE.match(tok):
        if re.match(r"^[+-]?\d+$", tok):
            return int(tok)
        return float(tok)
    return tok  # bare identifier (enum value)


class _Parser:
    def __init__(self, tokens: List[Tuple[str, str]]):
        self.toks = tokens
        self.pos = 0

    def peek(self) -> Tuple[str, str] | None:
        return self.toks[self.pos] if self.pos < len(self.toks) else None

    def next(self) -> Tuple[str, str]:
        tok = self.toks[self.pos]
        self.pos += 1
        return tok

    def expect(self, text: str) -> None:
        kind, tok = self.next()
        if tok != text:
            raise ValueError(f"expected {text!r}, got {tok!r} at token {self.pos}")

    def parse_message(self, closing: bool) -> ConfigNode:
        node = ConfigNode()
        while True:
            nxt = self.peek()
            if nxt is None:
                if closing:
                    raise ValueError("unexpected EOF inside message")
                return node
            if nxt[1] == "}":
                if not closing:
                    raise ValueError("unexpected '}' at top level")
                self.next()
                return node
            node.add(*self.parse_field())

    def parse_field(self) -> Tuple[str, Any]:
        kind, name = self.next()
        if kind != "atom":
            raise ValueError(f"expected field name, got {name!r}")
        nxt = self.peek()
        if nxt is None:
            raise ValueError(f"dangling field {name!r}")
        if nxt[1] == "{":  # message without colon
            self.next()
            return name, self.parse_message(closing=True)
        self.expect(":")
        nxt = self.peek()
        if nxt is None:
            raise ValueError(f"missing value for field {name!r}")
        if nxt[1] == "{":
            self.next()
            return name, self.parse_message(closing=True)
        if nxt[1] == "[":
            return name, self.parse_list()
        return name, self.parse_scalar()

    def parse_scalar(self) -> Any:
        kind, tok = self.next()
        if kind == "string":
            return tok[1:-1]
        if kind == "atom":
            return _convert_atom(tok)
        raise ValueError(f"unexpected token {tok!r} for scalar")

    def parse_list(self) -> List[Any]:
        self.expect("[")
        items: List[Any] = []
        while True:
            nxt = self.peek()
            if nxt is None:
                raise ValueError("unexpected EOF inside list")
            if nxt[1] == "]":
                self.next()
                return items
            if nxt[1] == ",":
                self.next()
                continue
            items.append(self.parse_scalar())


def parse_text(text: str) -> ConfigNode:
    return _Parser(list(_tokenize(text))).parse_message(closing=False)


def parse_file(path) -> ConfigNode:
    with open(path, "r") as f:
        return parse_text(f.read())
