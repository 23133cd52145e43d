"""A YAML writer for the run metadata, byte-equal to PyYAML's.

``dump(obj)`` returns what ``yaml.dump(obj, default_flow_style=False,
sort_keys=False)`` returns for the types the extract metadata holds: dicts
(str or int keys, in insertion order) and lists or tuples, nested in block
style (empty ones as ``{}`` and ``[]``), and str, int, float, bool and None
scalars. Strings are quoted where PyYAML quotes them (a plain form that
would read back as another type, indicator characters, surrounding
spaces, line breaks, characters outside printable ASCII) and long ones
fold at spaces past 80 columns as PyYAML folds them. The port does not
depend on PyYAML; this follows ``yaml/emitter.py``,
``yaml/representer.py`` and ``yaml/resolver.py`` of PyYAML 6.
"""

from __future__ import annotations

import re

_BEST_WIDTH = 80
_BEST_INDENT = 2
_BREAKS = "\n\x85\u2028\u2029"
_SPACE_OR_BREAK = "\0 \t\r\n\x85\u2028\u2029"

# The implicit resolvers of PyYAML's Resolver: a plain scalar that matches
# one of these reads back as that type, so a str with such a text is quoted.
_IMPLICIT = [re.compile(p, re.X) for p in (
    r"""^(?:yes|Yes|YES|no|No|NO
        |true|True|TRUE|false|False|FALSE
        |on|On|ON|off|Off|OFF)$""",
    r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
        |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
        |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
        |[-+]?\.(?:inf|Inf|INF)
        |\.(?:nan|NaN|NAN))$""",
    r"""^(?:[-+]?0b[0-1_]+
        |[-+]?0[0-7_]+
        |[-+]?(?:0|[1-9][0-9_]*)
        |[-+]?0x[0-9a-fA-F_]+
        |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""",
    r"^(?:<<)$",
    r"""^(?: ~
        |null|Null|NULL
        | )$""",
    r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
        |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
         (?:[Tt]|[ \t]+)[0-9][0-9]?
         :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
         (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""",
    r"^(?:=)$",
    r"^(?:!|&|\*)$",
)]

_ESCAPES = {
    "\0": "0", "\x07": "a", "\x08": "b", "\x09": "t", "\x0A": "n", "\x0B": "v", "\x0C": "f",
    "\x0D": "r", "\x1B": "e", '"': '"', "\\": "\\", "\x85": "N", "\xA0": "_", "\u2028": "L",
    "\u2029": "P",
}


def dump(obj) -> str:
    """``yaml.dump(obj, default_flow_style=False, sort_keys=False)`` for a
    dict or list of the supported types; raises TypeError on any other."""
    if not isinstance(obj, (dict, list, tuple)):
        raise TypeError(f"yaml_emit.dump takes a dict or a list, got {type(obj).__name__}")
    emitter = _Emitter()
    emitter.node(obj)
    emitter.write_indent()  # the document's end
    return "".join(emitter.out)


def _scalar_text(value) -> tuple:
    """(text, is_str) as PyYAML's representer writes ``value``."""
    if isinstance(value, str):
        return value, True
    if value is None:
        return "null", False
    if isinstance(value, bool):
        return ("true" if value else "false"), False
    if isinstance(value, int):
        return str(value), False
    if isinstance(value, float):
        if value != value:
            return ".nan", False
        if value in (float("inf"), float("-inf")):
            return (".inf" if value > 0 else "-.inf"), False
        text = repr(value).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text, False
    raise TypeError(f"yaml_emit cannot write a {type(value).__name__}: {value!r}")


class _Analysis:
    def __init__(self, empty=False, multiline=False, block_plain=True, single_quoted=True):
        self.empty = empty
        self.multiline = multiline
        self.block_plain = block_plain
        self.single_quoted = single_quoted


def _analyze(text: str) -> _Analysis:
    """PyYAML's ``Emitter.analyze_scalar`` for block context (no unicode
    allowed): which styles may write ``text``."""
    if not text:
        return _Analysis(empty=True)
    block_indicators = line_breaks = special = False
    leading_space = leading_break = trailing_space = trailing_break = False
    break_space = space_break = False
    if text.startswith("---") or text.startswith("..."):
        block_indicators = True
    preceded_by_ws = True
    followed_by_ws = len(text) == 1 or text[1] in _SPACE_OR_BREAK
    previous_space = previous_break = False
    for index, ch in enumerate(text):
        if index == 0:
            if ch in "#,[]{}&*!|>'\"%@`":
                block_indicators = True
            if ch in "?:" and followed_by_ws:
                block_indicators = True
            if ch == "-" and followed_by_ws:
                block_indicators = True
        else:
            if ch == ":" and followed_by_ws:
                block_indicators = True
            if ch == "#" and preceded_by_ws:
                block_indicators = True
        if ch in _BREAKS:
            line_breaks = True
        if not (ch == "\n" or "\x20" <= ch <= "\x7E"):
            special = True  # PyYAML's default: allow_unicode off
        if ch == " ":
            leading_space |= index == 0
            trailing_space |= index == len(text) - 1
            break_space |= previous_break
            previous_space, previous_break = True, False
        elif ch in _BREAKS:
            leading_break |= index == 0
            trailing_break |= index == len(text) - 1
            space_break |= previous_space
            previous_space, previous_break = False, True
        else:
            previous_space = previous_break = False
        preceded_by_ws = ch in _SPACE_OR_BREAK
        followed_by_ws = index + 2 >= len(text) or text[index + 2] in _SPACE_OR_BREAK
    block_plain = single_quoted = True
    if leading_space or leading_break or trailing_space or trailing_break:
        block_plain = False
    if break_space:
        block_plain = single_quoted = False
    if space_break or special:
        block_plain = single_quoted = False
    if line_breaks or block_indicators:
        block_plain = False
    return _Analysis(multiline=line_breaks, block_plain=block_plain, single_quoted=single_quoted)


class _Emitter:
    """The state of PyYAML's emitter that block output depends on."""

    def __init__(self):
        self.out = []
        self.column = 0
        self.whitespace = True
        self.indention = True
        self.indent = None
        self.indents = []
        self.mapping_context = False
        self.simple_key_context = False

    # ---------------------------------------------------------- nodes
    def node(self, value, mapping=False, simple_key=False):
        self.mapping_context = mapping
        self.simple_key_context = simple_key
        if isinstance(value, dict):
            if value:
                self.block_mapping(value)
            else:
                self.flow_empty("{", "}")
        elif isinstance(value, (list, tuple)):
            if value:
                self.block_sequence(value)
            else:
                self.flow_empty("[", "]")
        else:
            self.scalar(value)

    def flow_empty(self, open_, close):
        self.write_indicator(open_, True, whitespace=True)
        self.write_indicator(close, False)

    def block_mapping(self, mapping: dict):
        self.indents.append(self.indent)
        self.indent = 0 if self.indent is None else self.indent + _BEST_INDENT
        for key, value in mapping.items():
            if not isinstance(key, (str, int)) or isinstance(key, bool):
                raise TypeError(f"yaml_emit writes str and int keys, got {key!r}")
            text, _ = _scalar_text(key)
            analysis = _analyze(text)
            if len(text) >= 128 or analysis.empty or analysis.multiline:
                raise ValueError(f"yaml_emit writes simple keys only, got {key!r}")
            self.write_indent()
            self.node(key, mapping=True, simple_key=True)
            self.write_indicator(":", False)
            self.node(value, mapping=True)
        self.indent = self.indents.pop()

    def block_sequence(self, items):
        indentless = self.mapping_context and not self.indention
        self.indents.append(self.indent)
        if self.indent is None:
            self.indent = 0
        elif not indentless:
            self.indent += _BEST_INDENT
        for item in items:
            self.write_indent()
            self.write_indicator("-", True, indention=True)
            self.node(item)
        self.indent = self.indents.pop()

    def scalar(self, value):
        text, is_str = _scalar_text(value)
        analysis = _analyze(text)
        plain_reads_back = not is_str or not any(p.match(text) for p in _IMPLICIT)
        simple_key = self.simple_key_context
        split = not simple_key
        # a scalar's continuation lines indent one step further
        self.indents.append(self.indent)
        self.indent = _BEST_INDENT if self.indent is None else self.indent + _BEST_INDENT
        if (plain_reads_back and not (simple_key and (analysis.empty or analysis.multiline))
                and analysis.block_plain):
            self.write_plain(text, split)
        elif analysis.single_quoted and not (simple_key and analysis.multiline):
            self.write_single_quoted(text, split)
        else:
            self.write_double_quoted(text, split)
        self.indent = self.indents.pop()

    # ---------------------------------------------------------- writers
    def write(self, data: str):
        self.column += len(data)
        self.out.append(data)

    def write_indicator(self, indicator, need_whitespace, whitespace=False, indention=False):
        data = indicator if self.whitespace or not need_whitespace else " " + indicator
        self.whitespace = whitespace
        self.indention = self.indention and indention
        self.write(data)

    def write_indent(self):
        indent = self.indent or 0
        if (not self.indention or self.column > indent
                or (self.column == indent and not self.whitespace)):
            self.write_line_break()
        if self.column < indent:
            self.whitespace = True
            self.write(" " * (indent - self.column))

    def write_line_break(self, data="\n"):
        self.whitespace = True
        self.indention = True
        self.column = 0
        self.out.append(data)

    def write_breaks(self, breaks: str):
        if breaks[0] == "\n":
            self.write_line_break()
        for br in breaks:
            self.write_line_break("\n" if br == "\n" else br)
        self.write_indent()

    def write_plain(self, text, split):
        if not text:
            return
        if not self.whitespace:
            self.write(" ")
        self.whitespace = False
        self.indention = False
        spaces = breaks = False
        start = end = 0
        while end <= len(text):
            ch = text[end] if end < len(text) else None
            if spaces:
                if ch != " ":
                    if start + 1 == end and self.column > _BEST_WIDTH and split:
                        self.write_indent()
                        self.whitespace = False
                        self.indention = False
                    else:
                        self.write(text[start:end])
                    start = end
            elif breaks:
                if ch is None or ch not in _BREAKS:
                    self.write_breaks(text[start:end])
                    self.whitespace = False
                    self.indention = False
                    start = end
            elif ch is None or ch in " " + _BREAKS:
                self.write(text[start:end])
                start = end
            if ch is not None:
                spaces = ch == " "
                breaks = ch in _BREAKS
            end += 1

    def write_single_quoted(self, text, split):
        self.write_indicator("'", True)
        spaces = breaks = False
        start = end = 0
        while end <= len(text):
            ch = text[end] if end < len(text) else None
            if spaces:
                if ch is None or ch != " ":
                    if (start + 1 == end and self.column > _BEST_WIDTH and split
                            and start != 0 and end != len(text)):
                        self.write_indent()
                    else:
                        self.write(text[start:end])
                    start = end
            elif breaks:
                if ch is None or ch not in _BREAKS:
                    self.write_breaks(text[start:end])
                    start = end
            elif ch is None or ch in " " + _BREAKS or ch == "'":
                if start < end:
                    self.write(text[start:end])
                    start = end
            if ch == "'":
                self.write("''")
                start = end + 1
            if ch is not None:
                spaces = ch == " "
                breaks = ch in _BREAKS
            end += 1
        self.write_indicator("'", False)

    def write_double_quoted(self, text, split):
        self.write_indicator('"', True)
        start = end = 0
        while end <= len(text):
            ch = text[end] if end < len(text) else None
            if ch is None or ch in '"\\\x85\u2028\u2029\uFEFF' or not "\x20" <= ch <= "\x7E":
                if start < end:
                    self.write(text[start:end])
                    start = end
                if ch is not None:
                    if ch in _ESCAPES:
                        data = "\\" + _ESCAPES[ch]
                    elif ch <= "\xFF":
                        data = "\\x%02X" % ord(ch)
                    elif ch <= "\uFFFF":
                        data = "\\u%04X" % ord(ch)
                    else:
                        data = "\\U%08X" % ord(ch)
                    self.write(data)
                    start = end + 1
            if (0 < end < len(text) - 1 and (ch == " " or start >= end)
                    and self.column + (end - start) > _BEST_WIDTH and split):
                data = text[start:end] + "\\"
                if start < end:
                    start = end
                self.write(data)
                self.write_indent()
                self.whitespace = False
                self.indention = False
                if text[start] == " ":
                    self.write("\\")
            end += 1
        self.write_indicator('"', False)
