"""JMESPath-subset evaluator for metadata filters.

Counterpart of ``pathway_tpu/internals/jmespath_lite.py`` (stdlib only, copied so the
port imports nothing of that package). Document stores filter chunk metadata with it;
no jmespath package is assumed, so this evaluates the subset those filters use:

- dotted field paths (``owner``, ``meta.path``), raw ``'strings'``,
  backtick JSON literals, numbers, booleans, null
- comparisons ``== != < <= > >=``, boolean ``&& || !``, parentheses
- functions: ``globmatch(pattern, path)`` (with ``**`` crossing ``/``),
  ``contains(haystack, needle)``, ``starts_with``, ``ends_with``,
  ``to_string``
"""

from __future__ import annotations

import fnmatch
import json
import re
from typing import Any

_TOKEN = re.compile(
    r"""\s*(?:
        (?P<lparen>\()|(?P<rparen>\))|(?P<comma>,)|
        (?P<and>&&)|(?P<or>\|\|)|
        (?P<cmp>==|!=|<=|>=|<|>)|(?P<not>!)|
        (?P<raw>'(?:[^'\\]|\\.)*')|
        (?P<json>`(?:[^`\\]|\\.)*`)|
        (?P<number>-?\d+(?:\.\d+)?)|
        (?P<ident>[A-Za-z_][A-Za-z0-9_]*)|
        (?P<dot>\.)
    )""",
    re.VERBOSE,
)

_FUNCTIONS = ("globmatch", "contains", "starts_with", "ends_with", "to_string")


class JMESPathError(ValueError):
    pass


def _globmatch_parts(pattern: list, path: list) -> bool:
    if not pattern:
        return not path
    if pattern[0] == "**":
        if _globmatch_parts(pattern[1:], path):
            return True
        return bool(path) and _globmatch_parts(pattern, path[1:])
    if not path:
        return False
    if fnmatch.fnmatch(path[0], pattern[0]):
        return _globmatch_parts(pattern[1:], path[1:])
    return False


def globmatch(pattern: str, path: str) -> bool:
    """fnmatch at every /-level; ``**`` spans levels (reference
    _knn_lsh.py:101-122 _globmatch)."""
    return _globmatch_parts(str(pattern).split("/"), str(path).split("/"))


def _tokenize(text: str) -> list[tuple[str, str]]:
    out = []
    pos = 0
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if m is None:
            if text[pos:].strip() == "":
                break
            raise JMESPathError(f"bad filter syntax at {text[pos:]!r}")
        pos = m.end()
        for kind, value in m.groupdict().items():
            if value is not None:
                out.append((kind, value))
                break
    out.append(("eof", ""))
    return out


class _Parser:
    def __init__(self, tokens: list[tuple[str, str]], doc: Any) -> None:
        self.tokens = tokens
        self.i = 0
        self.doc = doc

    def peek(self) -> tuple[str, str]:
        return self.tokens[self.i]

    def next(self) -> tuple[str, str]:
        tok = self.tokens[self.i]
        self.i += 1
        return tok

    def expect(self, kind: str) -> str:
        k, v = self.next()
        if k != kind:
            raise JMESPathError(f"expected {kind}, got {v!r}")
        return v

    def or_expr(self) -> Any:
        left = self.and_expr()
        while self.peek()[0] == "or":
            self.next()
            right = self.and_expr()
            left = _truthy(left) or _truthy(right)
        return left

    def and_expr(self) -> Any:
        left = self.not_expr()
        while self.peek()[0] == "and":
            self.next()
            right = self.not_expr()
            left = _truthy(left) and _truthy(right)
        return left

    def not_expr(self) -> Any:
        if self.peek()[0] == "not":
            self.next()
            return not _truthy(self.not_expr())
        return self.comparison()

    def comparison(self) -> Any:
        left = self.operand()
        if self.peek()[0] == "cmp":
            op = self.next()[1]
            right = self.operand()
            try:
                if op == "==":
                    return left == right
                if op == "!=":
                    return left != right
                if left is None or right is None:
                    return False
                if op == "<":
                    return left < right
                if op == "<=":
                    return left <= right
                if op == ">":
                    return left > right
                if op == ">=":
                    return left >= right
            except TypeError:
                return False
        return left

    def operand(self) -> Any:
        kind, value = self.next()
        if kind == "lparen":
            out = self.or_expr()
            self.expect("rparen")
            return out
        if kind == "raw":
            return value[1:-1].replace("\\'", "'")
        if kind == "json":
            return json.loads(value[1:-1])
        if kind == "number":
            return float(value) if "." in value else int(value)
        if kind == "ident":
            if value in _FUNCTIONS and self.peek()[0] == "lparen":
                return self.call(value)
            if value == "true":
                return True
            if value == "false":
                return False
            if value == "null":
                return None
            return self.path(value)
        raise JMESPathError(f"unexpected token {value!r}")

    def call(self, name: str) -> Any:
        self.expect("lparen")
        args = [self.or_expr()]
        while self.peek()[0] == "comma":
            self.next()
            args.append(self.or_expr())
        self.expect("rparen")
        if name == "globmatch":
            return globmatch(args[0], args[1])
        if name == "contains":
            hay, needle = args
            if hay is None:
                return False
            return needle in hay
        if name == "starts_with":
            return str(args[0]).startswith(str(args[1]))
        if name == "ends_with":
            return str(args[0]).endswith(str(args[1]))
        if name == "to_string":
            v = args[0]
            return v if isinstance(v, str) else json.dumps(v)
        raise JMESPathError(f"unknown function {name}")

    def path(self, first: str) -> Any:
        node = self.doc
        parts = [first]
        while self.peek()[0] == "dot":
            self.next()
            parts.append(self.expect("ident"))
        for part in parts:
            if isinstance(node, dict):
                node = node.get(part)
            else:
                return None
        return node


def _truthy(v: Any) -> bool:
    # JMESPath truthiness: null / false / empty string / empty collection
    if v is None or v is False:
        return False
    if isinstance(v, (str, list, dict, tuple)) and len(v) == 0:
        return False
    return True


def search(expression: str, document: Any) -> Any:
    """Evaluate the filter expression against a (dict-like) document."""
    parser = _Parser(_tokenize(expression), document)
    out = parser.or_expr()
    if parser.peek()[0] != "eof":
        raise JMESPathError(
            f"trailing tokens in filter: {parser.peek()[1]!r}"
        )
    return out
