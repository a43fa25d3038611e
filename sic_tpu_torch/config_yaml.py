"""A reader for the subset of YAML that the reference's config files use.

The port imports no YAML library, so the reference-layout configs
(``configs/*.yaml``, ``tests/fixtures/config_tiny.yaml``) go through this
reader.  The subset:

- block mappings, nested at any indentation width (spaces only);
- flow sequences of scalars on one line (``[1,1,2,2,4]``, ``[1.0e-3]``);
- plain, single-quoted and double-quoted scalars;
- ``#`` comments, on lines of their own or after a value; blank lines.

Scalars resolve as PyYAML's ``safe_load`` resolves them (YAML 1.1): ``1e-4``
has no dot and stays the string ``"1e-4"``, while ``1.0e-3`` and ``0.001``
are floats; ``yes``/``no``/``on``/``off``/``true``/``false`` in their three
spellings are booleans; ``~``, ``null`` and an empty value are None;
``0x``, ``0b``, leading-zero octal and ``:``-sexagesimal numbers are ints.

Anything outside the subset raises ``ValueError`` naming its line: anchors
and aliases, tags, block scalars (``|``, ``>``), block sequences, flow
mappings, complex keys, document markers and directives (so no
multi-document file), timestamps, merge keys, multi-line scalars, tabs
outside comments and quoted scalars, and the control characters YAML does
not allow.  The reader never guesses.
"""
from __future__ import annotations

import re
from pathlib import Path

__all__ = ["safe_load", "load_path"]

# PyYAML's implicit resolvers (resolver.py), in its order of precedence
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                  |[-+]?0[0-7_]+
                  |[-+]?(?:0|[1-9][0-9_]*)
                  |[-+]?0x[0-9a-fA-F_]+
                  |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                        |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                        (?:[Tt]|[ \t]+)[0-9][0-9]?
                        :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                        (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)

_REFUSED_START = {"&": "an anchor", "*": "an alias", "!": "a tag",
                  "|": "a block scalar", ">": "a block scalar",
                  "{": "a flow mapping", "%": "a directive",
                  "@": "a reserved indicator", "`": "a reserved indicator"}
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": " ", "P": " "}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


class _Error(ValueError):
    pass


def _sexagesimal(text: str, cast):
    value = 0
    for part in text.split(":"):
        value = value * 60 + cast(part)
    return value


def _resolve(text: str):
    """A plain scalar's value, as PyYAML's SafeLoader constructs it."""
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _FLOAT.match(text):
        v = text.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        v = v.lstrip("+-")
        if v == ".inf":
            return sign * float("inf")
        if v == ".nan":
            return float("nan")
        return sign * (_sexagesimal(v, float) if ":" in v else float(v))
    if _INT.match(text):
        v = text.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v[0] == "0":
            return sign * int(v, 8)
        return sign * (_sexagesimal(v, int) if ":" in v else int(v))
    if _NULL.match(text):
        return None
    if _TIMESTAMP.match(text):
        raise _Error(f"the timestamp {text!r} is outside the subset; quote it")
    if text in ("<<", "="):
        raise _Error(f"the merge or value key {text!r} is outside the subset")
    return text


class _Line:
    """One line's text and a cursor over it."""

    def __init__(self, text: str):
        self.s = text
        self.i = 0

    def peek(self, k: int = 0) -> str:
        j = self.i + k
        return self.s[j] if j < len(self.s) else ""

    def skip_spaces(self) -> None:
        while self.peek() == " ":
            self.i += 1

    def at_end(self) -> bool:
        """Only spaces and a comment are left."""
        self.skip_spaces()
        return self.peek() in ("", "#")

    def quoted(self) -> str:
        q = self.peek()
        self.i += 1
        out = []
        while True:
            c = self.peek()
            if c == "":
                raise _Error("a quoted scalar runs past the end of its line "
                             "(multi-line scalars are outside the subset)")
            self.i += 1
            if q == "'":
                if c == "'":
                    if self.peek() == "'":
                        out.append("'")
                        self.i += 1
                        continue
                    return "".join(out)
                out.append(c)
            elif c == '"':
                return "".join(out)
            elif c == "\\":
                e = self.peek()
                self.i += 1
                if e in _ESCAPES:
                    out.append(_ESCAPES[e])
                elif e in _HEX_ESCAPES:
                    n = _HEX_ESCAPES[e]
                    code = self.s[self.i:self.i + n]
                    if len(code) != n or not re.fullmatch(r"[0-9A-Fa-f]+", code):
                        raise _Error(f"bad escape \\{e}{code}")
                    out.append(chr(int(code, 16)))
                    self.i += n
                else:
                    raise _Error(f"unknown escape \\{e}" if e else
                                 "a line break escaped in a double-quoted "
                                 "scalar is outside the subset")
            else:
                out.append(c)

    def check_start(self, flow: bool) -> None:
        """Refuse a node that starts with an indicator outside the subset."""
        c, nxt = self.peek(), self.peek(1)
        if c in _REFUSED_START:
            raise _Error(f"{_REFUSED_START[c]} ({c!r}) is outside the subset")
        if c in "-?:" and nxt in ("", " ") + ((",", "]") if flow else ()):
            what = {"-": "a block sequence", "?": "a complex key",
                    ":": "an empty key"}[c]
            raise _Error(f"{what} is outside the subset")
        if c == "[" and flow:
            raise _Error("nested flow collections are outside the subset")
        if c == "," and flow:
            raise _Error("an empty entry in a flow sequence")
        if c in "]},":
            raise _Error(f"unexpected {c!r}")

    def plain(self, flow: bool) -> str:
        """A plain scalar, up to a comment, ``: `` or (in a flow sequence)
        a comma or bracket."""
        start = self.i
        while True:
            c = self.peek()
            if c == "":
                break
            if c == "#" and self.i > start and self.s[self.i - 1] == " ":
                break
            if c == ":" and self.peek(1) in ("", " ") + ((",", "]") if flow else ()):
                raise _Error("a mapping inside a value is outside the subset")
            if flow and c in ",[]{}":
                break
            if c == "\t":
                raise _Error("a tab outside a comment or quoted scalar")
            self.i += 1
        return self.s[start:self.i].rstrip(" ")

    def scalar(self, flow: bool = False):
        self.check_start(flow)
        if self.peek() in ("'", '"'):
            return self.quoted()
        return _resolve(self.plain(flow))

    def flow_sequence(self) -> list:
        self.i += 1                       # '['
        out = []
        while True:
            self.skip_spaces()
            if self.peek() == "]":
                self.i += 1
                return out
            if self.peek() in ("", "#"):
                raise _Error("a flow sequence runs past the end of its line "
                             "(multi-line flow sequences are outside the subset)")
            out.append(self.scalar(flow=True))
            self.skip_spaces()
            c = self.peek()
            if c == ",":
                self.i += 1
            elif c != "]":
                raise _Error(f"expected ',' or ']' in a flow sequence, got {c!r}")


# the characters PyYAML's reader accepts
_PRINTABLE = re.compile("[^\x09\x0A\x0D\x20-\x7E\x85\xA0-\uD7FF"
                        "\uE000-\uFFFD\U00010000-\U0010FFFF]")


def _parse_line(text: str):
    """(indent, key, value, open) of one mapping entry, or None for a blank
    or comment line; ``open`` marks an entry whose value is on the lines
    below (or None)."""
    bad = _PRINTABLE.search(text)
    if bad:
        raise _Error(f"the character {bad.group()!r} is not allowed in YAML")
    ln = _Line(text)
    ln.skip_spaces()
    if ln.peek() == "\t":
        raise _Error("a tab used as indentation")
    if ln.at_end():
        return None
    indent = ln.i
    if indent == 0 and (re.match(r"(---|\.\.\.)(\s|$)", text) or text[0] == "%"):
        raise _Error("document markers and directives are outside the subset "
                     "(one document a file)")
    ln.check_start(flow=False)
    if ln.peek() == "[":
        raise _Error("a flow sequence as a key is outside the subset")
    if ln.peek() in ("'", '"'):
        key = ln.quoted()
        ln.skip_spaces()
        if ln.peek() != ":" or ln.peek(1) not in ("", " "):
            raise _Error("expected ':' after a quoted key")
        ln.i += 1
    else:
        m = re.search(r":(?= |$)", text[ln.i:])
        body = text[ln.i:ln.i + m.start()] if m else text[ln.i:]
        if not m or re.search(r"\s#", body):
            raise _Error("expected 'key: value' (continuation lines and bare "
                         "scalars are outside the subset)")
        if "\t" in body:
            raise _Error("a tab outside a comment or quoted scalar")
        key = _resolve(body.rstrip(" "))
        ln.i += m.end()
    if ln.at_end():
        return indent, key, None, True
    if ln.peek() == "[":
        value = ln.flow_sequence()
    else:
        value = ln.scalar()
    if not ln.at_end():
        raise _Error(f"unexpected text after the value: {ln.s[ln.i:]!r}")
    return indent, key, value, False


def safe_load(text: str, name: str = "<string>"):
    """The document ``text`` as ``yaml.safe_load`` would give it: a dict
    (or None for a document with no entries)."""
    root = None
    stack = []          # [indent, mapping] from the root down
    pending = None      # (mapping, key, indent) of an entry opened above
    for lineno, line in enumerate(text.splitlines(), 1):
        try:
            entry = _parse_line(line.rstrip("\r"))
            if entry is None:
                continue
            indent, key, value, is_open = entry
            if root is None:
                root = {}
                stack.append([indent, root])
            elif pending is not None and indent > pending[2]:
                child = {}
                pending[0][pending[1]] = child
                stack.append([indent, child])
            else:
                while stack and indent < stack[-1][0]:
                    stack.pop()
                if not stack or indent != stack[-1][0]:
                    raise _Error("this line's indentation matches no "
                                 "enclosing mapping")
            pending = None
            mapping = stack[-1][1]
            mapping[key] = value
            if is_open:
                pending = (mapping, key, indent)
        except _Error as e:
            raise ValueError(f"{name}, line {lineno}: {e}") from None
    return root


def load_path(path):
    """:func:`safe_load` of the file at ``path``."""
    p = Path(path)
    return safe_load(p.read_text(), name=str(p))
