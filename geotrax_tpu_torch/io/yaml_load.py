"""A YAML reader for the configuration files, equal to ``yaml.safe_load``
on the subset they use.

``safe_load(text_or_stream)`` reads block mappings and block sequences
(nested by indentation, a sequence also at its key's indentation), flow
sequences (``[a, 'b', [c]]``, across lines), comments, and plain,
single-quoted and double-quoted scalars on one line. Plain scalars resolve
as PyYAML's YAML 1.1 resolver resolves them: ``yes``/``no``/``on``/``off``
and ``true``/``false`` in three cases are booleans, ``~``, ``null`` and the
empty value are None, ``010`` is octal, ``0x``/``0b`` integers, ``1:30``
is sexagesimal, a float needs a dot (``1e-3`` stays a string) and an
exponent a sign, ``.inf``/``.nan``; keys resolve the same way.

Whatever lies outside the subset raises ``YAMLSubsetError`` and is never
guessed at: anchors, aliases, tags, block scalars (``|``, ``>``), flow
mappings, complex keys (``?``), merge keys, timestamps, directives, a
second document, tabs in indentation, and scalars continued on another
line. The port reads its presets and users' copies of them without
PyYAML, which the card's machine does not have.
"""

from __future__ import annotations

import math
import re

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
# resolved by PyYAML to types the subset does not construct
_REFUSED = re.compile(r"""^(?:<<|=
    |[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
    |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?(?:[Tt]|[ \t]+)[0-9][0-9]?
     :[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?(?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""",
                      re.X)

_ESCAPES = {
    "0": "\0", "a": "\x07", "b": "\x08", "t": "\x09", "\t": "\x09", "n": "\x0A", "v": "\x0B",
    "f": "\x0C", "r": "\x0D", "e": "\x1B", " ": " ", '"': '"', "/": "/", "\\": "\\",
    "N": "\x85", "_": "\xA0", "L": "\u2028", "P": "\u2029",
}
_ESCAPE_CODES = {"x": 2, "u": 4, "U": 8}
# characters that may not start a plain scalar (``-?:`` only when a space follows)
_NOT_PLAIN_START = ",[]{}#&*!|>'\"%@`"


class YAMLSubsetError(ValueError):
    """The document uses YAML outside the subset this reader takes."""


def _sexagesimal(value: str, cast):
    total, base = 0, 1
    for part in reversed(value.split(":")):
        total += cast(part) * base
        base *= 60
    return total


def resolve_plain(text: str):
    """The value of a plain scalar, as PyYAML's safe loader constructs it."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _INT.match(text):
        value = text.replace("_", "")
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
    if _FLOAT.match(text):
        value = text.replace("_", "").lower()
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
    if _REFUSED.match(text):
        raise YAMLSubsetError(f"plain scalar {text!r} resolves to a merge key, value or "
                              f"timestamp, which this reader does not construct")
    return text


class _Reader:
    def __init__(self, text: str):
        self.lines = []  # (line number, indent, content) of each line with content
        for number, raw in enumerate(text.replace("\r\n", "\n").replace("\r", "\n").split("\n"), 1):
            body = raw.lstrip(" ")
            indent = len(raw) - len(body)
            stripped = body.strip()
            if not stripped or stripped.startswith("#"):
                continue
            if body[0] == "\t":
                raise YAMLSubsetError(f"line {number}: a tab in the indentation")
            self.lines.append([number, indent, body.rstrip()])
        self.i = 0

    def fail(self, msg: str, number=None):
        number = number if number is not None else (
            self.lines[self.i][0] if self.i < len(self.lines) else "end")
        raise YAMLSubsetError(f"line {number}: {msg}")

    # ------------------------------------------------------------ document
    def document(self):
        if self.lines and self.lines[0][2].startswith("%"):
            self.fail("directives are not supported")
        if self.lines and self._is_marker(self.lines[0][2], "---"):
            rest = self.lines[0][2][3:].strip()
            if rest and not rest.startswith("#"):
                self.fail("content after '---' is not supported")
            self.i = 1
        if self.i >= len(self.lines):
            return None
        value = self.node(self.lines[self.i][1])
        if self.i < len(self.lines):
            line = self.lines[self.i][2]
            if self._is_marker(line, "---") or self._is_marker(line, "..."):
                self.fail("a second document (or a document end marker) is not supported")
            self.fail("content outside the document's structure")
        return value

    @staticmethod
    def _is_marker(line: str, marker: str) -> bool:
        return line.startswith(marker) and (len(line) == 3 or line[3] in " \t")

    # ------------------------------------------------------------ block nodes
    def node(self, indent: int):
        """The node whose first line is the current one, at ``indent``."""
        number, _, content = self.lines[self.i]
        if content[0] == "-" and (len(content) == 1 or content[1] == " "):
            return self.sequence(indent)
        if self._split_key(content, number) is not None:
            return self.mapping(indent)
        self.i += 1
        value = self.inline(content, number)
        if self.i < len(self.lines) and self.lines[self.i][1] > indent:
            self.fail("a scalar continued on another line is not supported")
        return value

    def sequence(self, indent: int) -> list:
        out = []
        while self.i < len(self.lines):
            number, ind, content = self.lines[self.i]
            if ind < indent:
                break
            if ind > indent:
                self.fail("unexpected indentation in a sequence")
            if not (content[0] == "-" and (len(content) == 1 or content[1] == " ")):
                break
            rest = content[1:].lstrip(" ")
            if not rest or rest.startswith("#"):
                self.i += 1
                if self.i < len(self.lines) and self.lines[self.i][1] > indent:
                    out.append(self.node(self.lines[self.i][1]))
                else:
                    out.append(None)
                continue
            # the item's content is a node at the column where it starts
            self.lines[self.i] = [number, ind + len(content) - len(rest), rest]
            out.append(self.node(ind + len(content) - len(rest)))
        return out

    def mapping(self, indent: int) -> dict:
        out = {}
        while self.i < len(self.lines):
            number, ind, content = self.lines[self.i]
            if ind < indent:
                break
            if ind > indent:
                self.fail("unexpected indentation in a mapping")
            split = self._split_key(content, number)
            if split is None:
                if content[0] == "-" and (len(content) == 1 or content[1] == " "):
                    break  # a sequence at its parent key's indentation ends here
                self.fail(f"expected 'key: value', found {content!r}")
            key, rest = split
            self.i += 1
            if rest and not rest.startswith("#"):
                value = self.inline(rest, number)
                if self.i < len(self.lines) and self.lines[self.i][1] > indent:
                    self.fail("a scalar continued on another line is not supported")
            elif self.i < len(self.lines) and self.lines[self.i][1] > indent:
                value = self.node(self.lines[self.i][1])
            elif (self.i < len(self.lines) and self.lines[self.i][1] == indent
                  and self.lines[self.i][2][0] == "-"
                  and (len(self.lines[self.i][2]) == 1 or self.lines[self.i][2][1] == " ")):
                value = self.sequence(indent)
            else:
                value = None
            try:
                out[key] = value
            except TypeError:
                self.fail(f"unhashable key {key!r}", number)
        return out

    def _split_key(self, content: str, number: int):
        """(key, rest of the line) when the line is a mapping entry, else
        None."""
        c = content[0]
        if c == "?" and (len(content) == 1 or content[1] == " "):
            self.fail("complex keys ('?') are not supported", number)
        if c in "'\"":
            text, end = self._quoted(content, 0, number)
            rest = content[end:].lstrip(" ")
            if rest[:1] == ":" and (len(rest) == 1 or rest[1] == " "):
                return text, rest[1:].strip()
            return None
        if c in "[{":
            return None
        pos = 0
        while True:
            pos = content.find(":", pos)
            if pos < 0:
                return None
            hash_pos = content.find(" #")
            if 0 <= hash_pos < pos:
                return None
            if pos + 1 == len(content) or content[pos + 1] == " ":
                break
            pos += 1
        key_text = content[:pos].rstrip(" ")
        if not key_text:
            self.fail("a mapping entry without a key", number)
        self._check_plain_start(key_text, number)
        return resolve_plain(key_text), content[pos + 1:].strip()

    # ------------------------------------------------------------ inline values
    def _check_plain_start(self, text: str, number: int, flow: bool = False) -> None:
        c = text[0]
        if c in "&*!":
            self.fail("anchors, aliases and tags are not supported", number)
        if c in "|>":
            self.fail("block scalars ('|', '>') are not supported", number)
        if c in _NOT_PLAIN_START or (c in "-?:" and (len(text) == 1 or text[1] in " ,[]{}")) or (
                flow and c in "?:"):
            self.fail(f"a plain scalar cannot start with {c!r}", number)

    def inline(self, text: str, number: int):
        """A value that starts on this line: a flow sequence, a quoted or a
        plain scalar; nothing but a comment may follow it."""
        if text[0] == "[":
            return self.flow_sequence(text, number)
        if text[0] == "{":
            self.fail("flow mappings are not supported", number)
        if text[0] in "'\"":
            value, end = self._quoted(text, 0, number)
            tail = text[end:].strip()
            if tail and not tail.startswith("#"):
                self.fail(f"unexpected text after a quoted scalar: {tail!r}", number)
            return value
        self._check_plain_start(text, number)
        hash_pos = text.find(" #")
        plain = (text[:hash_pos] if hash_pos >= 0 else text).rstrip(" ")
        if ": " in plain or plain.endswith(":"):
            self.fail("a mapping value is not allowed here", number)
        return resolve_plain(plain)

    def _quoted(self, text: str, start: int, number: int) -> tuple:
        """(value, index after the closing quote) of the quoted scalar that
        starts at ``start``."""
        quote = text[start]
        out = []
        i = start + 1
        while i < len(text):
            c = text[i]
            if quote == "'":
                if c == "'":
                    if text[i + 1:i + 2] == "'":
                        out.append("'")
                        i += 2
                        continue
                    return "".join(out), i + 1
                out.append(c)
                i += 1
                continue
            if c == '"':
                return "".join(out), i + 1
            if c == "\\":
                esc = text[i + 1:i + 2]
                if esc in _ESCAPES:
                    out.append(_ESCAPES[esc])
                    i += 2
                elif esc in _ESCAPE_CODES:
                    n = _ESCAPE_CODES[esc]
                    code = text[i + 2:i + 2 + n]
                    if len(code) != n or any(h not in "0123456789abcdefABCDEF" for h in code):
                        self.fail(f"bad escape \\{esc}{code}", number)
                    out.append(chr(int(code, 16)))
                    i += 2 + n
                elif esc == "":
                    self.fail("a double-quoted scalar continued on another line is not "
                              "supported", number)
                else:
                    self.fail(f"unknown escape \\{esc}", number)
                continue
            out.append(c)
            i += 1
        self.fail("a quoted scalar continued on another line is not supported", number)

    def flow_sequence(self, text: str, number: int) -> list:
        """A flow sequence from ``text`` (the rest of the current line) on,
        across as many following lines as it takes."""
        self.src = text
        self.pos = 0
        self.number = number
        value = self._flow_seq()
        tail = self.src[self.pos:].strip()
        if tail and not tail.startswith("#"):
            self.fail(f"unexpected text after a flow sequence: {tail!r}", self.number)
        return value

    def _skip_space(self) -> None:
        """Skip blanks, comments and line ends, pulling in the next line."""
        while True:
            while self.pos < len(self.src) and self.src[self.pos] == " ":
                self.pos += 1
            if self.pos < len(self.src) and self.src[self.pos] == "#" and (
                    self.pos == 0 or self.src[self.pos - 1] == " "):
                self.pos = len(self.src)
            if self.pos < len(self.src):
                return
            if self.i >= len(self.lines):
                self.fail("a flow sequence is not closed", self.number)
            self.number, _, self.src = self.lines[self.i]
            self.pos = 0
            self.i += 1

    def _flow_seq(self) -> list:
        self.pos += 1  # '['
        out = []
        while True:
            self._skip_space()
            c = self.src[self.pos]
            if c == "]":
                self.pos += 1
                return out
            if c == ",":
                self.fail("an empty entry in a flow sequence", self.number)
            if c == "[":
                out.append(self._flow_seq())
            elif c == "{":
                self.fail("flow mappings are not supported", self.number)
            elif c in "'\"":
                value, self.pos = self._quoted(self.src, self.pos, self.number)
                out.append(value)
            else:
                out.append(self._flow_plain())
            self._skip_space()
            c = self.src[self.pos]
            if c == ",":
                self.pos += 1
            elif c == "]":
                continue
            elif c == ":":
                self.fail("mappings inside a flow sequence are not supported", self.number)
            else:
                self.fail(f"expected ',' or ']' in a flow sequence, found {c!r}", self.number)

    def _flow_plain(self):
        start = self.pos
        text = self.src
        self._check_plain_start(text[start:], self.number, flow=True)
        i = start
        while i < len(text):
            c = text[i]
            if c in ",[]{}?":
                break
            if c == ":" and (i + 1 == len(text) or text[i + 1] in " ,[]{}"):
                self.fail("mappings inside a flow sequence are not supported", self.number)
            if c == "#" and text[i - 1] == " ":
                break
            i += 1
        self.pos = i
        return resolve_plain(text[start:i].rstrip(" "))


def safe_load(stream):
    """The document in ``stream`` (a str, bytes or a file object), as
    ``yaml.safe_load`` reads it; raises ``YAMLSubsetError`` outside the
    subset."""
    text = stream if isinstance(stream, (str, bytes)) else stream.read()
    if isinstance(text, bytes):
        text = text.decode("utf-8")
    if text.startswith("\ufeff"):
        text = text[1:]
    return _Reader(text).document()
