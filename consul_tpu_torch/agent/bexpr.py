"""Boolean-expression result filtering: the ``?filter=`` query param;
the port's copy of ``consul_tpu/agent/bexpr.py``.

Equivalent of the vendored ``go-bexpr`` used by ``agent/http.go``
(parseFilter → bexpr.CreateFilter): list endpoints accept a filter
expression evaluated against each (camelized) result row, e.g.

    ServiceName == "web" and Checks.Status != "critical"
    "primary" in ServiceTags
    Node.Meta.env is not empty
    ServiceName matches "web-.*"

Grammar (the go-bexpr surface, minus struct-tag pointers):

    expr        := or
    or          := and ("or" and)*
    and         := unary ("and" unary)*
    unary       := "not" unary | "(" expr ")" | comparison
    comparison  := selector binop value
                 | value ("in" | "not in") selector
                 | selector ("contains" | "not contains") value
                 | selector "is" ["not"] "empty"
                 | selector ["not"] "matches" value
    binop       := "==" | "!="
    selector    := Ident ("." Ident)*
    value       := "string" | `string` | number | true | false

Selectors traverse nested dicts; a selector that crosses a LIST fans
out over the elements and the comparison succeeds if ANY element
matches (go-bexpr collection semantics for membership-style use).
"""

from __future__ import annotations

import re
from typing import Any


class FilterError(ValueError):
    """Bad filter expression (400 at the HTTP layer)."""


_TOKEN_RE = re.compile(
    r"""
    \s*(?:
        (?P<lparen>\() | (?P<rparen>\))
      | (?P<eq>==) | (?P<ne>!=)
      | (?P<string>"(?:[^"\\]|\\.)*"|`[^`]*`)
      | (?P<number>-?\d+(?:\.\d+)?)
      | (?P<ident>[A-Za-z_][A-Za-z0-9_-]*(?:\.[A-Za-z0-9_-]+)*)
    )
    """,
    re.VERBOSE,
)

_KEYWORDS = {"and", "or", "not", "in", "contains", "is", "empty",
             "matches", "true", "false"}


def _tokenize(src: str) -> list[tuple[str, str]]:
    out, pos = [], 0
    while pos < len(src):
        if src[pos:].strip() == "":
            break
        m = _TOKEN_RE.match(src, pos)
        if m is None:
            raise FilterError(f"bad filter syntax at {src[pos:pos+20]!r}")
        pos = m.end()
        kind = m.lastgroup
        text = m.group(kind)
        if kind == "ident" and text.lower() in _KEYWORDS and "." not in text:
            out.append((text.lower(), text))
        else:
            out.append((kind, text))
    out.append(("eof", ""))
    return out


def _resolve(row: Any, path: list[str]) -> list[Any]:
    """Selector traversal; lists fan out (any-match semantics)."""
    values = [row]
    for part in path:
        nxt: list[Any] = []
        for v in values:
            if isinstance(v, list):
                v_items = v
            else:
                v_items = [v]
            for item in v_items:
                if isinstance(item, dict) and part in item:
                    nxt.append(item[part])
        values = nxt
        if not values:
            return []
    # Final fan-out: a trailing list selector exposes BOTH the list
    # itself (so `in`/`is empty` see it) and its elements (so ==/matches
    # compare against each element, go-bexpr any-match semantics).
    flat: list[Any] = []
    for v in values:
        flat.append(v)
        if isinstance(v, list):
            flat.extend(v)
    return flat


class _Parser:
    def __init__(self, tokens: list[tuple[str, str]]):
        self.tokens = tokens
        self.pos = 0

    def peek(self) -> tuple[str, str]:
        return self.tokens[self.pos]

    def next(self) -> tuple[str, str]:
        tok = self.tokens[self.pos]
        self.pos += 1
        return tok

    def expect(self, kind: str) -> str:
        k, text = self.next()
        if k != kind:
            raise FilterError(f"expected {kind}, got {text!r}")
        return text

    # -- grammar -------------------------------------------------------

    def parse(self):
        node = self.parse_or()
        if self.peek()[0] != "eof":
            raise FilterError(f"unexpected {self.peek()[1]!r}")
        return node

    def parse_or(self):
        left = self.parse_and()
        while self.peek()[0] == "or":
            self.next()
            right = self.parse_and()
            left = ("or", left, right)
        return left

    def parse_and(self):
        left = self.parse_unary()
        while self.peek()[0] == "and":
            self.next()
            right = self.parse_unary()
            left = ("and", left, right)
        return left

    def parse_unary(self):
        kind, _ = self.peek()
        if kind == "not":
            self.next()
            return ("not", self.parse_unary())
        if kind == "lparen":
            self.next()
            node = self.parse_or()
            self.expect("rparen")
            return node
        return self.parse_comparison()

    def _value(self):
        kind, text = self.next()
        if kind == "string":
            return text[1:-1] if text[0] == "`" else _unescape(text[1:-1])
        if kind == "number":
            return float(text) if "." in text else int(text)
        if kind in ("true", "false"):
            return kind == "true"
        raise FilterError(f"expected a value, got {text!r}")

    def parse_comparison(self):
        kind, text = self.peek()
        if kind in ("string", "number", "true", "false"):
            # <Value> in <Selector> / <Value> not in <Selector>
            value = self._value()
            negate = False
            if self.peek()[0] == "not":
                self.next()
                negate = True
            k, t = self.next()
            if k != "in":
                raise FilterError(f"expected 'in', got {t!r}")
            sel = self.expect("ident").split(".")
            node = ("in", value, sel)
            return ("not", node) if negate else node
        sel = self.expect("ident").split(".")
        k, t = self.next()
        if k == "eq":
            return ("==", sel, self._value())
        if k == "ne":
            return ("!=", sel, self._value())
        if k == "contains":
            return ("in", self._value(), sel)
        if k == "matches":
            return ("matches", sel, self._value())
        if k == "not":
            k2, t2 = self.next()
            if k2 == "contains":
                return ("not", ("in", self._value(), sel))
            if k2 == "matches":
                return ("not", ("matches", sel, self._value()))
            raise FilterError(f"unexpected {t2!r} after 'not'")
        if k == "is":
            negate = False
            if self.peek()[0] == "not":
                self.next()
                negate = True
            self.expect("empty")
            node = ("empty", sel)
            return ("not", node) if negate else node
        if k == "in":
            # <Selector> in <Value-selector>? go-bexpr only allows
            # value-in-selector; mirror its error.
            raise FilterError("left side of 'in' must be a value")
        raise FilterError(f"expected an operator, got {t!r}")


def _unescape(s: str) -> str:
    return s.replace('\\"', '"').replace("\\\\", "\\")


def _loose_eq(a: Any, b: Any) -> bool:
    if isinstance(a, bool) or isinstance(b, bool):
        return a is b if isinstance(a, bool) and isinstance(b, bool) else False
    if isinstance(a, (int, float)) and isinstance(b, (int, float)):
        return float(a) == float(b)
    return a == b


def _eval(node, row: Any) -> bool:
    op = node[0]
    if op == "and":
        return _eval(node[1], row) and _eval(node[2], row)
    if op == "or":
        return _eval(node[1], row) or _eval(node[2], row)
    if op == "not":
        return not _eval(node[1], row)
    if op == "==":
        values = _resolve(row, node[1])
        return any(_loose_eq(v, node[2]) for v in values)
    if op == "!=":
        values = _resolve(row, node[1])
        # go-bexpr: != over a collection means NO element equals.
        return not any(_loose_eq(v, node[2]) for v in values)
    if op == "in":
        values = _resolve(row, node[2])
        for v in values:
            if isinstance(v, list) and any(
                _loose_eq(item, node[1]) for item in v
            ):
                return True
            if isinstance(v, dict) and node[1] in v:
                return True
            if isinstance(v, str) and isinstance(node[1], str) \
                    and node[1] in v:
                return True
            if _loose_eq(v, node[1]):
                return True
        return False
    if op == "empty":
        values = _resolve(row, node[1])
        if not values:
            return True
        return all(
            v is None or v == "" or v == [] or v == {} for v in values
        )
    if op == "matches":
        try:
            rx = re.compile(str(node[2]))
        except re.error as e:
            raise FilterError(f"bad regex {node[2]!r}: {e}") from e
        return any(
            isinstance(v, str) and rx.search(v)
            for v in _resolve(row, node[1])
        )
    raise FilterError(f"unknown op {op!r}")


class Filter:
    """bexpr.Filter: compile once, apply to many rows."""

    def __init__(self, expression: str):
        self._ast = _Parser(_tokenize(expression)).parse()

    def match(self, row: Any) -> bool:
        return _eval(self._ast, row)

    def apply(self, rows: list) -> list:
        return [r for r in rows if self.match(r)]


def create_filter(expression: str) -> Filter:
    return Filter(expression)
