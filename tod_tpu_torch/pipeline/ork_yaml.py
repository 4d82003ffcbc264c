"""A reader for the YAML subset that ``.ork`` files use, without pyyaml.

``tod_tpu/pipeline/ork.py`` reads ``.ork`` files with ``yaml.safe_load``;
the port runs where pyyaml is not installed. :func:`safe_load` gives what
``yaml.safe_load`` gives for this subset:

- ``#`` comments, on their own line or after a value;
- block mappings nested by indentation, and block sequences (``- item``);
- flow sequences and mappings (``[source1]``, ``{type: ORB, n: 5}``),
  nested, on one line or spread over several;
- single- and double-quoted scalars, and plain scalars resolved as YAML 1.1
  resolves them (pyyaml's implicit resolvers): null (``~``, ``null``,
  empty), bool (``true``/``false``, ``yes``/``no``, ``on``/``off``), int
  (decimal, ``0x`` hex, ``0b`` binary, ``0``-prefixed octal, ``_``
  separators), float (with a ``.``, ``.inf``, ``.nan``), else str.

Anything else (anchors, aliases, tags, block scalars ``|`` / ``>``, several
documents, sexagesimal numbers) raises ``ValueError``.
"""

from __future__ import annotations

import math
import re
from typing import Any, List, Tuple

# YAML 1.1 implicit resolvers (pyyaml's resolver.py)
_BOOL = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE",
                           "on", "On", "ON")}
_BOOL.update({v: False for v in ("no", "No", "NO", "false", "False", "FALSE",
                                 "off", "Off", "OFF")})
_NULL = {"~", "null", "Null", "NULL", ""}
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9_]+(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_UNSUPPORTED = ("&", "*", "!", "|", ">", "%", "@", "`")


def _fail(lineno: int, why: str):
    raise ValueError(f".ork line {lineno}: {why}")


def _resolve(text: str, lineno: int) -> Any:
    """A plain scalar's value."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        if ":" in text:
            _fail(lineno, f"sexagesimal number {text!r} is outside the "
                  ".ork subset")
        t = text.replace("_", "")
        sign = -1 if t.startswith("-") else 1
        t = t.lstrip("+-")
        if t.startswith("0b"):
            return sign * int(t[2:], 2)
        if t.startswith("0x"):
            return sign * int(t[2:], 16)
        if t != "0" and t.startswith("0"):
            return sign * int(t, 8)
        return sign * int(t)
    if _FLOAT.match(text):
        if ":" in text:
            _fail(lineno, f"sexagesimal number {text!r} is outside the "
                  ".ork subset")
        t = text.replace("_", "").lower()
        if t.endswith(".inf"):
            return -math.inf if t.startswith("-") else math.inf
        if t == ".nan":
            return math.nan
        return float(t)
    if text[0] in _UNSUPPORTED:
        _fail(lineno, f"{text!r} is outside the .ork subset")
    return text


def _quoted(s: str, i: int, lineno: int) -> Tuple[str, int]:
    """The quoted scalar starting at ``s[i]``: (value, index past it)."""
    q = s[i]
    out: List[str] = []
    j = i + 1
    while j < len(s):
        c = s[j]
        if c == q:
            if q == "'" and j + 1 < len(s) and s[j + 1] == "'":
                out.append("'")
                j += 2
                continue
            return "".join(out), j + 1
        if q == '"' and c == "\\":
            esc = s[j + 1] if j + 1 < len(s) else ""
            table = {"n": "\n", "t": "\t", "\\": "\\", '"': '"', "/": "/",
                     "0": "\0", "r": "\r", " ": " "}
            if esc not in table:
                _fail(lineno, f"escape \\{esc} is outside the .ork subset")
            out.append(table[esc])
            j += 2
            continue
        out.append(c)
        j += 1
    _fail(lineno, "unterminated quoted scalar")


def _strip_comment(line: str) -> str:
    """``line`` without a trailing ``# comment`` (a ``#`` at the start or
    after white space, outside quotes)."""
    quote, skip = None, False
    for i, c in enumerate(line):
        if skip:
            skip = False
        elif quote:
            if c == quote and quote == "'" and line[i + 1:i + 2] == "'":
                skip = True             # '' inside single quotes
            elif c == "\\" and quote == '"':
                skip = True             # an escape inside double quotes
            elif c == quote:
                quote = None
        elif c in "'\"" and (i == 0 or line[i - 1] in " \t[{,:"):
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


class _Flow:
    """A recursive-descent reader of one flow collection."""

    def __init__(self, text: str, lineno: int):
        self.s, self.i, self.lineno = text, 0, lineno

    def ws(self) -> None:
        while self.i < len(self.s) and self.s[self.i] in " \t\n":
            self.i += 1

    def node(self) -> Any:
        self.ws()
        c = self.s[self.i] if self.i < len(self.s) else ""
        if c == "[":
            return self.seq()
        if c == "{":
            return self.mapping()
        if c in "'\"":
            value, self.i = _quoted(self.s, self.i, self.lineno)
            return value
        j = self.i
        while j < len(self.s) and self.s[j] not in ",[]{}" \
                and not (self.s[j] == ":" and (j + 1 == len(self.s)
                                               or self.s[j + 1] in " ,]}")):
            j += 1
        text = self.s[self.i:j].strip()
        self.i = j
        return _resolve(text, self.lineno)

    def expect(self, c: str) -> None:
        self.ws()
        if self.i >= len(self.s) or self.s[self.i] != c:
            _fail(self.lineno, f"expected {c!r} in flow collection "
                  f"{self.s!r}")
        self.i += 1

    def seq(self) -> list:
        self.expect("[")
        out = []
        self.ws()
        while self.s[self.i:self.i + 1] != "]":
            if self.i >= len(self.s):
                _fail(self.lineno, f"unterminated flow collection {self.s!r}")
            out.append(self.node())
            self.ws()
            if self.s[self.i:self.i + 1] == ",":
                self.i += 1
                self.ws()
            elif self.s[self.i:self.i + 1] != "]":
                _fail(self.lineno, f"expected ',' or ']' in {self.s!r}")
        self.i += 1
        return out

    def mapping(self) -> dict:
        self.expect("{")
        out = {}
        self.ws()
        while self.s[self.i:self.i + 1] != "}":
            if self.i >= len(self.s):
                _fail(self.lineno, f"unterminated flow collection {self.s!r}")
            key = self.node()
            self.ws()
            value = None
            if self.s[self.i:self.i + 1] == ":":
                self.i += 1
                self.ws()
                if self.s[self.i:self.i + 1] not in (",", "}"):
                    value = self.node()
            out[key] = value
            self.ws()
            if self.s[self.i:self.i + 1] == ",":
                self.i += 1
                self.ws()
            elif self.s[self.i:self.i + 1] != "}":
                _fail(self.lineno, f"expected ',' or '}}' in {self.s!r}")
        self.i += 1
        return out

    def whole(self) -> Any:
        value = self.node()
        self.ws()
        if self.i != len(self.s):
            _fail(self.lineno, f"text after a flow collection: "
                  f"{self.s[self.i:]!r}")
        return value


def _balanced(text: str) -> bool:
    depth, quote = 0, None
    for c in text:
        if quote:
            if c == quote:
                quote = None
        elif c in "'\"":
            quote = c
        elif c in "[{":
            depth += 1
        elif c in "]}":
            depth -= 1
    return depth <= 0


def _split_key(content: str, lineno: int):
    """``(key, rest)`` of a ``key: value`` line, or None if it has no
    mapping colon."""
    if content[0] in "'\"":
        key, j = _quoted(content, 0, lineno)
        rest = content[j:].lstrip()
        if not rest.startswith(":"):
            return None
        return key, rest[1:].strip()
    for j, c in enumerate(content):
        if c == ":" and (j + 1 == len(content) or content[j + 1] in " \t"):
            return _resolve(content[:j].strip(), lineno), \
                content[j + 1:].strip()
        if c in "[{" and j == 0:
            return None
    return None


class _Block:
    def __init__(self, lines: List[Tuple[int, int, str]]):
        self.lines = lines     # (lineno, indent, content)
        self.k = 0

    def value(self, rest: str, lineno: int, indent: int) -> Any:
        """The value after ``key:`` or ``-``: inline, or the nested block
        below (deeper than ``indent``)."""
        if rest == "":
            if self.k < len(self.lines) and self.lines[self.k][1] > indent:
                return self.node(self.lines[self.k][1])
            # a sequence may sit at its key's indent
            if self.k < len(self.lines) and self.lines[self.k][1] == indent \
                    and self.lines[self.k][2].startswith("- "):
                return self.node(indent)
            return None
        if rest[0] in "[{":
            while not _balanced(rest):
                if self.k >= len(self.lines):
                    _fail(lineno, "unterminated flow collection")
                rest += " " + self.lines[self.k][2]
                self.k += 1
            return _Flow(rest, lineno).whole()
        if rest[0] in "'\"":
            value, j = _quoted(rest, 0, lineno)
            if rest[j:].strip():
                _fail(lineno, f"text after a quoted scalar: {rest[j:]!r}")
            return value
        if rest in ("|", ">") or rest[0] in "|>":
            _fail(lineno, "block scalars are outside the .ork subset")
        return _resolve(rest, lineno)

    def node(self, indent: int) -> Any:
        lineno, _, content = self.lines[self.k]
        if content == "-" or content.startswith("- "):
            return self.sequence(indent)
        if _split_key(content, lineno) is None:
            self.k += 1
            return self.value(content, lineno, indent - 1)
        return self.mapping(indent)

    def sequence(self, indent: int) -> list:
        out = []
        while self.k < len(self.lines):
            lineno, ind, content = self.lines[self.k]
            dash = content == "-" or content.startswith("- ")
            if ind < indent or (ind == indent and not dash):
                break
            if ind > indent:
                _fail(lineno, f"bad indentation: {content!r}")
            rest = content[1:].strip()
            self.k += 1
            if rest and _split_key(rest, lineno) is not None \
                    and rest[0] not in "[{":
                # a mapping that starts on the dash's line
                item_indent = ind + len(content) - len(content[1:].lstrip())
                self.lines.insert(self.k, (lineno, item_indent, rest))
                out.append(self.node(item_indent))
            else:
                out.append(self.value(rest, lineno, ind))
        return out

    def mapping(self, indent: int) -> dict:
        out = {}
        while self.k < len(self.lines):
            lineno, ind, content = self.lines[self.k]
            if ind < indent:
                break
            if ind > indent:
                _fail(lineno, f"bad indentation: {content!r}")
            split = _split_key(content, lineno)
            if split is None:
                _fail(lineno, f"expected 'key: value', got {content!r}")
            key, rest = split
            self.k += 1
            out[key] = self.value(rest, lineno, ind)
        return out


def safe_load(text: str) -> Any:
    """The document of ``text`` as ``yaml.safe_load`` reads it (see the
    module's docstring for the subset); None for an empty document."""
    lines = []
    for lineno, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            _fail(lineno, "tabs in indentation")
        line = _strip_comment(raw)
        if not line.strip():
            continue
        content = line.strip()
        if content in ("---", "...") or content.startswith("--- "):
            _fail(lineno, "document markers are outside the .ork subset")
        lines.append((lineno, len(line) - len(line.lstrip()), content))
    if not lines:
        return None
    block = _Block(lines)
    doc = block.node(lines[0][1])
    if block.k != len(block.lines):
        lineno, _, content = block.lines[block.k]
        _fail(lineno, f"unexpected {content!r}")
    return doc


def load_file(path: str) -> Any:
    with open(path) as f:
        return safe_load(f.read())
