"""A reader of the YAML that ``configs/`` uses, in the standard library, so
the port composes the repo's configs where the ``yaml`` package is not
installed. What it reads means what PyYAML's ``safe_load`` (YAML 1.1) makes
of it, types included.

    tree = load_file(path)          # a config file
    value = load_string(raw)        # a ``key=value`` override's value

The subset:

* block mappings and block sequences, a sequence's entries mappings too
  (``- "in": []`` with ``"out": [...]`` under it), a mapping's sequence at
  the key's own indent, plain and quoted keys;
* flow sequences and flow mappings (``[1., 1.2]``, ``{d_model: 64}``,
  ``{"a":1}``), nested, each closed on its own line;
* single- and double-quoted scalars (``''``, and the backslash escapes),
  each closed on its own line, and ``#`` comments;
* plain scalars with YAML 1.1's implicit types: ``true``/``yes``/``on``
  and their capitals with the false forms alike, ``null``/``~``/the empty
  scalar, ints in decimal, with ``_``, ``0b``, ``0x``, leading-``0`` octal
  and base 60, floats only with a dot (so ``1e-2`` stays a string while
  ``1.``, ``1.e-3``, ``.inf`` and ``.nan`` are floats), and timestamps
  (``YYYY-MM-DD`` a ``datetime.date``); anything else a string.

Outside it, every construct raises ``ValueError`` naming the file and the
line rather than being read another way: anchors, aliases, tags, block
scalars (``|``, ``>``), ``?`` keys, merge keys, document markers and
directives (so one document a file), multi-line plain, quoted or flow
scalars, tabs outside quotes and the characters YAML cannot hold.
"""

from __future__ import annotations

import datetime
import math
import re
from pathlib import Path

__all__ = ["load_file", "load_string"]

# YAML 1.1's implicit types, as PyYAML resolves a plain scalar
_BOOL_RE = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF)$")
_BOOLS = {"yes": True, "no": False, "true": True, "false": False, "on": True, "off": False}
_FLOAT_RE = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT_RE = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL_RE = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP_RE = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
_TIMESTAMP_PARTS = re.compile(r"""^(?P<year>[0-9][0-9][0-9][0-9])
                -(?P<month>[0-9][0-9]?)
                -(?P<day>[0-9][0-9]?)
                (?:(?:[Tt]|[ \t]+)
                (?P<hour>[0-9][0-9]?)
                :(?P<minute>[0-9][0-9])
                :(?P<second>[0-9][0-9])
                (?:\.(?P<fraction>[0-9]*))?
                (?:[ \t]*(?P<tz>Z|(?P<tz_sign>[-+])(?P<tz_hour>[0-9][0-9]?)
                (?::(?P<tz_minute>[0-9][0-9]))?))?)?$""", re.X)

# the double-quoted escapes
_ESCAPES = {"0": "\x00", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t", "n": "\n", "v": "\x0b", "f": "\x0c",
            "r": "\r", "e": "\x1b", " ": " ", '"': '"', "\\": "\\", "/": "/", "N": "\x85", "_": "\xa0",
            "L": "\u2028", "P": "\u2029"}
_ESCAPE_CODES = {"x": 2, "u": 4, "U": 8}
# what YAML cannot hold, and the line breaks other than \n and \r
_NON_PRINTABLE = re.compile("[^\x09\x0A\x0D\x20-\x7E\x85\xA0-\uD7FF\uE000-\uFFFD\U00010000-\U0010FFFF]")
_OTHER_BREAKS = re.compile("[\x85\u2028\u2029]")
# characters that cannot start a plain scalar, but '-', '?' and ':' before a non-space
_INDICATORS = "-?:,[]{}#&*!|>'\"%@`"
_FLOW_STOP = ",?[]{}"
_EMPTY = object()  # nothing after a key's ':' or an entry's '-' on its line


def load_file(path) -> object:
    """The document of the YAML file at ``path``."""
    return _Reader(Path(path).read_text(encoding="utf-8"), str(path)).document()


def load_string(text: str, where: str = "<string>") -> object:
    """The document ``text`` holds, as ``yaml.safe_load(text)`` reads it
    (None for an empty one)."""
    return _Reader(text, where).document()


def resolve_plain(value: str):
    """A plain scalar's value under YAML 1.1's implicit types."""
    if _BOOL_RE.match(value):
        return _BOOLS[value.lower()]
    if _FLOAT_RE.match(value):
        return _float(value)
    if _INT_RE.match(value):
        return _int(value)
    if _NULL_RE.match(value):
        return None
    if _TIMESTAMP_RE.match(value):
        return _timestamp(value)
    return value


def _sexagesimal(value: str, kind):
    total, base = kind(0), 1
    for part in reversed(value.split(":")):
        total += kind(part) * base
        base *= 60
    return total


def _int(value: str) -> int:
    value = value.replace("_", "")
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    if ":" in value:
        return sign * _sexagesimal(value, int)
    return sign * int(value)


def _float(value: str) -> float:
    value = value.replace("_", "").lower()
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * math.inf
    if value == ".nan":
        return math.nan
    if ":" in value:
        return sign * _sexagesimal(value, float)
    return sign * float(value)


def _timestamp(value: str):
    parts = _TIMESTAMP_PARTS.match(value).groupdict()
    year, month, day = int(parts["year"]), int(parts["month"]), int(parts["day"])
    if not parts["hour"]:
        return datetime.date(year, month, day)
    fraction = int(parts["fraction"][:6].ljust(6, "0")) if parts["fraction"] else 0
    tzinfo = None
    if parts["tz_sign"]:
        delta = datetime.timedelta(hours=int(parts["tz_hour"]), minutes=int(parts["tz_minute"] or 0))
        tzinfo = datetime.timezone(-delta if parts["tz_sign"] == "-" else delta)
    elif parts["tz"]:
        tzinfo = datetime.timezone.utc
    return datetime.datetime(year, month, day, int(parts["hour"]), int(parts["minute"]), int(parts["second"]),
                             fraction, tzinfo=tzinfo)


def _is_entry(text: str) -> bool:
    """A block sequence entry: '-' alone or before a space."""
    return text == "-" or text.startswith("- ")


class _Reader:
    def __init__(self, text: str, where: str):
        self.where = where
        if text.startswith("\ufeff"):
            text = text[1:]
        self.lines = []  # [line number, indent, text]: no blank or comment-only line
        for number, line in enumerate(re.split(r"\r\n|\r|\n", text), 1):
            self.line = number
            bad = _NON_PRINTABLE.search(line) or _OTHER_BREAKS.search(line)
            if bad:
                self.fail(f"the character {bad.group()!r} is outside the subset")
            body = line.lstrip(" ")
            indent = len(line) - len(body)
            if body.startswith("\t"):
                self.fail("a tab in the indentation is outside the subset")
            body = body.rstrip(" ")
            if not body or body.startswith("#"):
                continue
            if line.startswith(("---", "...")) and line[3:4] in ("", " ", "\t"):
                self.fail(f"the document marker {line[:3]!r} is outside the subset (one document a file)")
            self.lines.append([number, indent, body])

    def fail(self, message: str):
        raise ValueError(f"{self.where}:{self.line}: {message}")

    # --- block structure ----------------------------------------------------------------------------------------

    def document(self):
        if not self.lines:
            return None
        value, pos = self.block(0, -1)
        if pos < len(self.lines):
            self.line = self.lines[pos][0]
            self.fail("content after the document's top node")
        return value

    def block(self, pos: int, parent: int):
        """The node whose first line is ``lines[pos]``, inside a container
        at indent ``parent``: (value, the next line's position)."""
        number, indent, text = self.lines[pos]
        self.line = number
        if _is_entry(text):
            return self.sequence(pos, indent)
        if self.split_key(text) is not None:
            return self.mapping(pos, indent)
        value = self.inline(text)
        pos += 1
        if pos < len(self.lines) and self.lines[pos][1] > parent:
            self.line = self.lines[pos][0]
            self.fail("a continued line: multi-line scalars are outside the subset")
        return value, pos

    def sequence(self, pos: int, indent: int):
        items = []
        while pos < len(self.lines):
            number, at, text = self.lines[pos]
            self.line = number
            if at < indent or (at == indent and not _is_entry(text)):
                break
            if at > indent:
                self.fail("bad indentation of a sequence entry")
            rest = text[1:]
            body = rest.lstrip(" ")
            if not body or body.startswith("#"):
                pos += 1
                value = None
                if pos < len(self.lines) and self.lines[pos][1] > indent:
                    value, pos = self.block(pos, indent)
            else:  # the entry's node starts on its own line, at the column after '- '
                self.lines[pos] = [number, indent + 1 + len(rest) - len(body), body]
                value, pos = self.block(pos, indent)
            items.append(value)
        return items, pos

    def mapping(self, pos: int, indent: int):
        result = {}
        while pos < len(self.lines):
            number, at, text = self.lines[pos]
            self.line = number
            if at < indent:
                break
            if at > indent:
                self.fail("bad indentation of a mapping entry")
            pair = self.split_key(text)
            if pair is None:
                self.fail("a line that is not 'key: value' inside a mapping")
            key, rest = pair
            value = self.inline(rest)
            pos += 1
            following = self.lines[pos] if pos < len(self.lines) else None
            if value is _EMPTY:
                value = None
                if following is not None and (following[1] > indent
                                              or (following[1] == indent and _is_entry(following[2]))):
                    value, pos = self.block(pos, indent)
            elif following is not None and following[1] > indent:
                self.line = following[0]
                self.fail("a continued line: multi-line scalars are outside the subset")
            self.line = number
            try:
                result[key] = value
            except TypeError:
                self.fail(f"the unhashable key {key!r}")
        return result, pos

    def split_key(self, text: str):
        """(key, what follows its ':') where ``text`` is a mapping entry,
        else None."""
        if text[0] in "'\"":
            key, end = self.quoted(text, 0)
            end = self.skip_spaces(text, end)
            if end < len(text) and text[end] == ":" and (end + 1 == len(text) or text[end + 1] == " "):
                return key, text[end + 1:]
            return None
        if text.startswith(("? ", "?\t")) or text == "?":
            self.fail("a '?' key is outside the subset")
        if not self.starts_plain(text, 0, flow=False):
            return None
        raw, end, stop = self.plain(text, 0, flow=False)
        if stop != ":":
            return None
        if raw == "<<":
            self.fail("a merge key ('<<') is outside the subset")
        return resolve_plain(raw), text[end + 1:]

    # --- scalars and flow collections on one line -------------------------------------------------------------

    def inline(self, text: str):
        """The value that ``text`` (what follows a key's ':', or a line of
        its own) holds, or ``_EMPTY``."""
        start = self.skip_spaces(text, 0)
        if start == len(text) or text[start] == "#":
            return _EMPTY
        ch = text[start]
        if ch in "[{":
            value, end = self.flow(text, start)
        elif ch in "'\"":
            value, end = self.quoted(text, start)
        else:
            if not self.starts_plain(text, start, flow=False):
                self.unexpected(text, start)
            raw, end, stop = self.plain(text, start, flow=False)
            if stop == ":":
                self.fail("a mapping value where a scalar is expected ('key: value' in a value)")
            value = self.scalar(raw)
        end = self.skip_spaces(text, end)
        if end < len(text) and text[end] != "#":
            self.fail(f"unexpected {text[end:]!r} after a value")
        return value

    def scalar(self, raw: str):
        if raw == "<<":
            self.fail("a merge key ('<<') is outside the subset")
        if raw == "=":
            self.fail("the value key '=' is outside the subset")
        return resolve_plain(raw)

    def unexpected(self, text: str, i: int):
        ch = text[i]
        if ch in "&*":
            self.fail("anchors and aliases are outside the subset")
        if ch == "!":
            self.fail("tags are outside the subset")
        if ch in "|>":
            self.fail("block scalars ('|', '>') are outside the subset")
        if ch == "-":
            self.fail("a sequence entry where a value is expected")
        if ch in "?:":
            self.fail(f"a {ch!r} indicator is outside the subset")
        self.fail(f"the character {ch!r} cannot start a value")

    def skip_spaces(self, text: str, i: int) -> int:
        while i < len(text) and text[i] in " \t":
            if text[i] == "\t":
                self.fail("a tab outside quotes is outside the subset")
            i += 1
        return i

    @staticmethod
    def starts_plain(text: str, i: int, flow: bool) -> bool:
        ch = text[i]
        if ch not in _INDICATORS:
            return True
        nxt = text[i + 1] if i + 1 < len(text) else " "
        return nxt not in " \t" and (ch == "-" or (not flow and ch in "?:"))

    def plain(self, text: str, i: int, flow: bool):
        """A plain scalar from ``text[i]``: (its text, the index after it,
        what stopped it: ':' for a value indicator, else '')."""
        n, end, j = len(text), i, i
        while True:
            k = j
            while k < n:
                ch = text[k]
                if ch == "\t":
                    self.fail("a tab outside quotes is outside the subset")
                if ch == " " or (flow and ch in _FLOW_STOP):
                    break
                if ch == ":" and (k + 1 == n or text[k + 1] in " \t" or (flow and text[k + 1] in ",[]{}")):
                    return text[i:k].rstrip(" "), k, ":"
                k += 1
            if k == j:
                break
            end = k
            m = self.skip_spaces(text, k)
            if m == k or m == n or text[m] == "#":
                break
            j = m
        return text[i:end], end, ""

    def quoted(self, text: str, i: int):
        """A quoted scalar from ``text[i]``: (its value, the index after its
        closing quote)."""
        quote, j, out, n = text[i], i + 1, [], len(text)
        while True:
            if j >= n:
                self.fail("a quoted scalar not closed on its line (multi-line scalars are outside the subset)")
            ch = text[j]
            if quote == "'":
                if ch == "'":
                    if j + 1 < n and text[j + 1] == "'":
                        out.append("'")
                        j += 2
                        continue
                    return "".join(out), j + 1
                out.append(ch)
                j += 1
            elif ch == '"':
                return "".join(out), j + 1
            elif ch == "\\":
                if j + 1 >= n:
                    self.fail("a line continuation in a double-quoted scalar is outside the subset")
                code = text[j + 1]
                if code in _ESCAPES:
                    out.append(_ESCAPES[code])
                    j += 2
                elif code in _ESCAPE_CODES:
                    digits = text[j + 2:j + 2 + _ESCAPE_CODES[code]]
                    if len(digits) < _ESCAPE_CODES[code] or any(c not in "0123456789abcdefABCDEF" for c in digits):
                        self.fail(f"a bad '\\{code}' escape in a double-quoted scalar")
                    out.append(chr(int(digits, 16)))
                    j += 2 + len(digits)
                else:
                    self.fail(f"an unknown escape '\\{code}' in a double-quoted scalar")
            else:
                out.append(ch)
                j += 1

    def flow(self, text: str, i: int):
        """A flow sequence or mapping from ``text[i]``: (its value, the
        index after it)."""
        closing = "]" if text[i] == "[" else "}"
        result = [] if closing == "]" else {}
        j = i + 1
        while True:
            j = self.skip_spaces(text, j)
            if j >= len(text) or text[j] == "#":
                self.fail("a flow collection not closed on its line (multi-line ones are outside the subset)")
            if text[j] == closing:
                return result, j + 1
            value, j = self.flow_node(text, j)
            j = self.skip_spaces(text, j)
            if closing == "]":
                if j < len(text) and text[j] == ":":
                    self.fail("a 'key: value' pair inside a flow sequence is outside the subset")
                result.append(value)
            else:
                key, value = value, None
                if j < len(text) and text[j] == ":":
                    j = self.skip_spaces(text, j + 1)
                    if j < len(text) and text[j] not in ",}":
                        value, j = self.flow_node(text, j)
                        j = self.skip_spaces(text, j)
                try:
                    result[key] = value
                except TypeError:
                    self.fail(f"the unhashable key {key!r}")
            if j < len(text) and text[j] == ",":
                j += 1
            elif j < len(text) and text[j] == closing:
                return result, j + 1
            elif j < len(text) and text[j] != "#":
                self.fail(f"unexpected {text[j]!r} in a flow collection")

    def flow_node(self, text: str, i: int):
        ch = text[i]
        if ch in "[{":
            return self.flow(text, i)
        if ch in "'\"":
            return self.quoted(text, i)
        if not self.starts_plain(text, i, flow=True):
            self.unexpected(text, i)
        raw, end, _ = self.plain(text, i, flow=True)
        if end < len(text) and text[end] == "?":
            self.fail("a '?' inside a flow collection is outside the subset")
        return self.scalar(raw), end
