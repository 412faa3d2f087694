r"""A reader and writer for the YAML subset the scheduler's files use.

The port stands where the JAX package uses PyYAML (`yaml.safe_load` /
`yaml.safe_dump(..., default_flow_style=None)`), on hosts that do not
have PyYAML. It reads and writes the subset that `native/miniyaml.h`
reads, which is everything PyYAML's emitter produces for the profiler's
results, `models.yml`, `device_types.yml`, `devices.yml` and the
schedule `sched-pipeline` prints:

- block mappings nested by indentation, including a block sequence at
  the same indentation as its key (as PyYAML writes it);
- block sequences, including `- key: value` mapping items and `- [a, b]`;
- flow sequences `[a, b]`, nested and wrapped over several lines, and
  flow mappings `{a: 1}` (PyYAML writes an empty mapping as `{}`);
- plain, single- and double-quoted scalars, comments, `---`.

Plain scalars resolve as PyYAML's safe loader resolves them (YAML 1.1)
for the forms these files hold: null, bool, decimal int and float.
`1e-05` is a string there (a float needs a dot in its mantissa), so the
writer spells floats as `yaml.safe_dump` does (`1.0e-05`, `3.2e-05`,
`0.0001`). The other YAML 1.1 numbers (octal, binary, hex, sexagesimal,
digits with `_`), anchors, tags, block scalars and double-quote escapes
other than `\\`, `\"`, `\x`, `\u` and `\U` are refused.
"""
from __future__ import annotations

import math
import numbers
import re
from typing import Any, List, Tuple

# PyYAML's implicit resolvers (yaml/resolver.py), safe loader; int and
# float cut to their decimal forms
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                   r"|FALSE|on|On|ON|off|Off|OFF)$")
_TRUE = {"yes", "true", "on"}
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9]*)$")
_FLOAT = re.compile(r"^(?:[-+]?[0-9]+\.[0-9]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9]+(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
# PyYAML's int and float resolvers whole: what they take and the two
# above do not is a number outside the subset
_YAML11_NUMBER = re.compile(
    r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
    r"|[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+"
    r"|[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*)$")
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


class YamlError(ValueError):
    """The text is outside the subset (or is not YAML)."""


def resolve_plain(text: str) -> Any:
    """A plain scalar's value, as PyYAML's safe loader gives it."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in _TRUE
    if _INT.match(text):
        return int(text)
    if _FLOAT.match(text):
        digits = text.lower()
        sign = -1.0 if digits[0] == "-" else 1.0
        if digits.lstrip("+-") == ".inf":
            return sign * math.inf
        if digits == ".nan":
            return math.nan
        return float(digits)
    if _YAML11_NUMBER.match(text):
        raise YamlError(f"a YAML 1.1 number outside the subset: {text!r}")
    return text


# --- reading ---------------------------------------------------------------

def _scan(text: str, stop: str, start: int = 0) -> int:
    """Index of the first character of `stop` at `start` or after, outside
    quotes and brackets; len(text) if none. A `:` counts only before a
    space or the end, a `#` only after a space or at the start."""
    depth = 0
    i = start
    while i < len(text):
        c = text[i]
        if c in "'\"" and (i == 0 or text[i - 1] in " [{,:-"):
            i = _quote_end(text, i)
            continue
        if c in "[{":
            depth += 1
        elif c in "]}":
            depth -= 1
        elif depth == 0 and c in stop:
            if c == ":" and (i + 1 == len(text) or text[i + 1] == " "):
                return i
            if c == "#" and (i == 0 or text[i - 1] in " \t"):
                return i
        i += 1
    return len(text)


def _quote_end(text: str, i: int) -> int:
    """Index just past the quoted scalar that opens at `text[i]`."""
    quote = text[i]
    j = i + 1
    while j < len(text):
        if quote == "'" and text[j] == "'":
            if j + 1 < len(text) and text[j + 1] == "'":
                j += 2
                continue
            return j + 1
        if quote == '"' and text[j] == "\\":
            j += 2
            continue
        if quote == '"' and text[j] == '"':
            return j + 1
        j += 1
    raise YamlError(f"unterminated quoted scalar: {text[i:]!r}")


def _balance(text: str) -> int:
    depth = 0
    i = 0
    while i < len(text):
        c = text[i]
        if c in "'\"" and (i == 0 or text[i - 1] in " [{,:-"):
            i = _quote_end(text, i)
            continue
        depth += (c in "[{") - (c in "]}")
        i += 1
    return depth


def _unquote(text: str) -> str:
    body = text[1:-1]
    if text[0] == "'":
        return body.replace("''", "'")
    out = []
    i = 0
    while i < len(body):
        c = body[i]
        if c != "\\":
            out.append(c)
            i += 1
            continue
        esc = body[i + 1]
        if esc in _HEX_ESCAPES:
            n = _HEX_ESCAPES[esc]
            out.append(chr(int(body[i + 2:i + 2 + n], 16)))
            i += 2 + n
        elif esc in '"\\':
            out.append(esc)
            i += 2
        else:
            raise YamlError(f"unknown escape \\{esc} in {text!r}")
    return "".join(out)


def _scalar(text: str) -> Any:
    text = text.strip()
    if text[:1] in ("'", '"'):
        if _quote_end(text, 0) != len(text):
            raise YamlError(f"text after a quoted scalar: {text!r}")
        return _unquote(text)
    if text[:1] in ("&", "*", "!", "|", ">", "%", "@", "`"):
        raise YamlError(f"outside the subset: {text!r}")
    return resolve_plain(text)


class _Flow:
    """Recursive-descent reader of one flow collection."""

    def __init__(self, text: str):
        self.text = text
        self.i = 0

    def _skip(self):
        while self.i < len(self.text) and self.text[self.i] in " \t":
            self.i += 1

    def value(self) -> Any:
        self._skip()
        c = self.text[self.i:self.i + 1]
        if c == "[":
            return self._collection("]", self._seq_item, [])
        if c == "{":
            return self._collection("}", self._map_item, {})
        if c in ("'", '"'):
            end = _quote_end(self.text, self.i)
            token, self.i = self.text[self.i:end], end
            return _scalar(token)
        start = self.i
        while self.i < len(self.text) and self.text[self.i] not in ",]}" \
                and not (self.text[self.i] == ":" and self.text[
                    self.i + 1:self.i + 2] in (" ", "")):
            self.i += 1
        return _scalar(self.text[start:self.i])

    def _collection(self, close, item, out):
        self.i += 1
        while True:
            self._skip()
            if self.text[self.i:self.i + 1] == close:
                self.i += 1
                return out
            item(out)
            self._skip()
            c = self.text[self.i:self.i + 1]
            if c == ",":
                self.i += 1
            elif c != close:
                raise YamlError(f"expected ',' or {close!r} in "
                                f"{self.text!r}")

    def _seq_item(self, out: list):
        out.append(self.value())

    def _map_item(self, out: dict):
        key = self.value()
        self._skip()
        if self.text[self.i:self.i + 1] != ":":
            raise YamlError(f"expected ':' in {self.text!r}")
        self.i += 1
        out[key] = self.value()


def _inline(text: str) -> Any:
    if text[:1] in ("[", "{"):
        flow = _Flow(text)
        value = flow.value()
        if text[flow.i:].strip():
            raise YamlError(f"text after a flow collection: {text!r}")
        return value
    return _scalar(text)


def _lines(doc: str) -> List[Tuple[int, str]]:
    """(indent, text) per logical line: comments and blank lines dropped,
    wrapped flow collections joined into one line."""
    out: List[Tuple[int, str]] = []
    pending = None
    for raw in doc.splitlines():
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise YamlError(f"tab in indentation: {raw!r}")
        text = raw[:_scan(raw, "#")].rstrip()
        if pending is not None:
            pending = (pending[0], pending[1] + " " + text.strip())
            if _balance(pending[1]) <= 0:
                out.append(pending)
                pending = None
            continue
        stripped = text.strip()
        if not stripped or stripped in ("---", "..."):
            continue
        line = (len(text) - len(text.lstrip(" ")), stripped)
        if _balance(stripped) > 0:
            pending = line
        else:
            out.append(line)
    if pending is not None:
        raise YamlError(f"unclosed flow collection: {pending[1]!r}")
    return out


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


class _Block:
    """Recursive-descent reader over the logical lines."""

    def __init__(self, lines: List[Tuple[int, str]]):
        self.lines = lines
        self.i = 0

    def node(self, min_indent: int) -> Any:
        if self.i >= len(self.lines) or self.lines[self.i][0] < min_indent:
            return None
        indent, text = self.lines[self.i]
        if _is_item(text):
            return self.seq(indent)
        if _scan(text, ":") < len(text):
            return self.mapping(indent)
        self.i += 1
        return _inline(text)

    def seq(self, indent: int) -> list:
        out = []
        while self.i < len(self.lines):
            ind, text = self.lines[self.i]
            if ind != indent or not _is_item(text):
                break
            rest = text[1:].lstrip(" ")
            if not rest:
                self.i += 1
                out.append(self.node(indent + 1))
                continue
            # the item's text stands at its own column: re-read it there
            col = indent + len(text) - len(rest)
            self.lines[self.i] = (col, rest)
            out.append(self.node(col))
        return out

    def mapping(self, indent: int) -> dict:
        out = {}
        while self.i < len(self.lines):
            ind, text = self.lines[self.i]
            if ind != indent or _is_item(text):
                break
            split = _scan(text, ":")
            if split == len(text):
                raise YamlError(f"expected 'key: value': {text!r}")
            key = _inline(text[:split].strip())
            if isinstance(key, (list, dict)):
                raise YamlError(f"collection as a key: {text!r}")
            if key in out:
                raise YamlError(f"duplicate key {key!r}")
            value = text[split + 1:].strip()
            self.i += 1
            if value:
                out[key] = _inline(value)
            elif self.i < len(self.lines) and self.lines[self.i][0] == indent \
                    and _is_item(self.lines[self.i][1]):
                out[key] = self.seq(indent)   # a sequence beside its key
            else:
                out[key] = self.node(indent + 1)
        return out


def loads(doc: str) -> Any:
    """The document's value (None for an empty document), as
    `yaml.safe_load` reads it."""
    block = _Block(_lines(doc))
    value = block.node(0)
    if block.i != len(block.lines):
        raise YamlError(f"unexpected line: {block.lines[block.i][1]!r}")
    return value


def load(path) -> Any:
    with open(path, "r", encoding="utf-8") as f:
        return loads(f.read())


# --- writing ---------------------------------------------------------------

WIDTH = 80          # PyYAML's default line width for wrapped flow lists
_PLAIN_START = set("-?:,[]{}#&*!|>'\"%@`")


def format_float(x: float) -> str:
    """A float as `yaml.safe_dump` spells it: always a dot in the
    mantissa, so YAML 1.1 readers read a float back."""
    if x != x:
        return ".nan"
    if x in (math.inf, -math.inf):
        return ".inf" if x > 0 else "-.inf"
    text = repr(float(x)).lower()
    if "." not in text and "e" in text:
        text = text.replace("e", ".0e", 1)
    return text


def _resolves_to_str(s: str) -> bool:
    try:
        return isinstance(resolve_plain(s), str)
    except YamlError:
        return False


def _format_str(s: str) -> str:
    if not all(c.isprintable() for c in s):
        raise YamlError(f"a string with unprintable characters: {s!r}")
    plain = (s and s == s.strip() and s[0] not in _PLAIN_START
             and ": " not in s and " #" not in s and not s.endswith(":")
             and _resolves_to_str(s))
    return s if plain else "'" + s.replace("'", "''") + "'"


def format_scalar(value: Any) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, numbers.Integral):
        return str(int(value))
    if isinstance(value, numbers.Real):
        return format_float(float(value))
    if isinstance(value, str):
        return _format_str(value)
    raise TypeError(f"cannot write {type(value).__name__} as a YAML scalar")


def _is_scalar(value) -> bool:
    return not isinstance(value, (list, tuple, dict))


def _flow_lines(items: List[str], lead: str, indent: int) -> List[str]:
    """`lead[a, b, ...]`, wrapped past WIDTH as PyYAML wraps it; the
    continuation lines indent by `indent` + 2."""
    if not items:
        return [lead + "[]"]
    lines, cur = [], lead + "["
    for n, item in enumerate(items):
        piece = item + ("]" if n == len(items) - 1 else ",")
        if not cur.endswith("[") and len(cur) > WIDTH:
            lines.append(cur)
            cur = " " * (indent + 2) + piece
        else:
            cur += ("" if cur.endswith("[") else " ") + piece
    lines.append(cur)
    return lines


def _emit(value, indent: int, lead: str, out: List[str], sort_keys: bool):
    """Append `value` at `indent`; `lead` is what precedes it on its
    first line (`key: ` or `- `, already indented)."""
    if isinstance(value, dict):
        if not value:
            out.append(lead + "{}")
            return
        keys = sorted(value, key=_sort_key) if sort_keys else list(value)
        first = True
        for key in keys:
            k = format_scalar(key)
            head = (lead if first else " " * indent) + k + ":"
            first = False
            _emit_entry(value[key], indent, head, out, sort_keys)
        return
    if isinstance(value, (list, tuple)):
        if all(_is_scalar(v) for v in value):
            out.extend(_flow_lines([format_scalar(v) for v in value], lead,
                                   indent))
            return
        if lead.strip():
            out.append(lead.rstrip())
        for item in value:
            _emit(item, indent + 2, " " * indent + "- ", out, sort_keys)
        return
    out.append(lead + format_scalar(value))


def _emit_entry(value, indent: int, head: str, out: List[str],
                sort_keys: bool):
    """One `key:` line and its value."""
    if isinstance(value, dict) and value:
        out.append(head)
        _emit(value, indent + 2, " " * (indent + 2), out, sort_keys)
    elif isinstance(value, (list, tuple)) and value \
            and not all(_is_scalar(v) for v in value):
        out.append(head)
        for item in value:     # a sequence beside its key, as PyYAML writes
            _emit(item, indent + 2, " " * indent + "- ", out, sort_keys)
    else:
        _emit(value, indent, head + " ", out, sort_keys)


def _sort_key(key):
    return (type(key).__name__, key)


def dumps(value: Any, sort_keys: bool = True) -> str:
    """`value` in the subset, leaf lists in flow style, as
    `yaml.safe_dump(value, default_flow_style=None)` lays it out."""
    out: List[str] = []
    _emit(value, 0, "", out, sort_keys)
    return "\n".join(out) + "\n"


def dump(value: Any, path, sort_keys: bool = True) -> None:
    with open(path, "w", encoding="utf-8") as f:
        f.write(dumps(value, sort_keys=sort_keys))
