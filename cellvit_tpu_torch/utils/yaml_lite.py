"""A reader (and a small writer) for the subset of YAML that `yaml.safe_dump`
writes (a preprocessed slide's `metadata.yaml`, a run's `config.yaml`) and
that the files under `configs/` use, without PyYAML.

`load` reads:
- block mappings and block sequences, nested by indentation (a sequence may
  sit at its key's indentation, as safe_dump writes it), and sequence items
  that open a mapping or a sequence on their line (`- key: value`, `- - x`);
- comments: whole lines and the rest of a line from a `#` that follows
  whitespace outside quotes;
- flow sequences and flow mappings of scalars (`[0.85, 0.95]`, `{p: 0.5}`,
  `[]`, `{}`);
- keys in single or double quotes (`"Adrenal_gland": 0`; the escapes `\\`,
  `\"`, `\n` and `\t`);
- scalars resolved as YAML 1.1's core schema resolves them: decimal ints,
  floats (`1.0e-05`, `.inf`, `-.inf`, `.nan`), `null`/`~`/empty, booleans
  (`true`/`false`, `yes`/`no`, `on`/`off` in their three spellings), single
  quoted strings (with the `''` escape) and plain strings.

Anything else (double-quoted values, nested flow collections, multi-line
scalars, anchors, tags, octal, hexadecimal or sexagesimal numbers, dates,
several documents) raises `YAMLError`. `dump` writes the block subset:
sorted keys, block style.
"""

from __future__ import annotations

import math
import re
from typing import Any, List, Tuple

_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?$")
_INF = re.compile(r"[-+]?\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)$")
_BOOL = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")}
_BOOL.update({v: False for v in ("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF")})
_NULL = ("", "~", "null", "Null", "NULL")
#: plain scalars YAML 1.1 resolves to types outside the subset
_OTHER = re.compile(r"[-+]?0b[0-1_]+$|[-+]?0[0-7_]+$|[-+]?0x[0-9a-fA-F_]+$"
                    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?$"
                    r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}|<<$|=$")


class YAMLError(ValueError):
    """Text outside the subset this reader supports."""


def _scalar(text: str) -> Any:
    """One scalar token (already stripped) → its value."""
    if text.startswith("'"):
        if len(text) < 2 or not text.endswith("'"):
            raise YAMLError(f"unterminated single-quoted scalar: {text!r}")
        body = text[1:-1]
        if re.search(r"(?<!')'(?!')", body.replace("''", "")):
            raise YAMLError(f"bad quoting: {text!r}")
        return body.replace("''", "'")
    if text[:1] in ('"', "&", "*", "!", "|", ">", "%", "@", "`"):
        raise YAMLError(f"unsupported scalar: {text!r}")
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if _INF.match(text):
        return -math.inf if text[0] == "-" else math.inf
    if _NAN.match(text):
        return math.nan
    if _OTHER.match(text):
        raise YAMLError(f"scalar type outside the subset: {text!r}")
    if " #" in text or text.startswith("#"):
        raise YAMLError(f"comments are not supported: {text!r}")
    return text


def _flow_items(body: str) -> List[str]:
    """The comma-separated items of a flow collection's body, split outside
    quotes; nested collections raise."""
    items, start, quote = [], 0, None
    for i, ch in enumerate(body):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and not body[start:i].strip():
            quote = ch
        elif ch in "[]{}":
            raise YAMLError(f"nested flow collections are not supported: {body!r}")
        elif ch == ",":
            items.append(body[start:i].strip())
            start = i + 1
    items.append(body[start:].strip())
    if quote or any(not item for item in items):
        raise YAMLError(f"bad flow collection: {body!r}")
    return items


def _value(text: str) -> Any:
    """An inline value: a flow collection of scalars or a scalar."""
    if text.startswith(("[", "{")):
        close = "]" if text[0] == "[" else "}"
        if not text.endswith(close):
            raise YAMLError(f"unterminated flow collection: {text!r}")
        body = text[1:-1].strip()
        items = _flow_items(body) if body else []
        if close == "]":
            return [_scalar(item) for item in items]
        out = {}
        for item in items:
            key, rest = _split_key(item)
            if key in out:
                raise YAMLError(f"duplicate key {key!r}")
            out[key] = _scalar(rest) if rest is not None else None
        return out
    return _scalar(text)


_ESCAPES = {"\\": "\\", '"': '"', "n": "\n", "t": "\t"}


def _double_quoted_key(text: str) -> Tuple[str, str]:
    """A double-quoted key at the start of `text` → (key, the rest)."""
    out, i = [], 1
    while i < len(text):
        ch = text[i]
        if ch == '"':
            return "".join(out), text[i + 1:]
        if ch == "\\":
            if text[i + 1:i + 2] not in _ESCAPES:
                raise YAMLError(f"unsupported escape in {text!r}")
            out.append(_ESCAPES[text[i + 1]])
            i += 2
            continue
        out.append(ch)
        i += 1
    raise YAMLError(f"unterminated quoted key: {text!r}")


def _split_key(text: str) -> Tuple[Any, Any]:
    """'key: value' → (key, value text or None when the line ends the key);
    raises when the text is not a mapping entry."""
    if text.startswith('"'):
        key, rest = _double_quoted_key(text)
        if not (rest == ":" or rest.startswith(": ")):
            raise YAMLError(f"not a mapping entry: {text!r}")
        rest = rest[1:].strip()
        return key, (rest if rest else None)
    if text.startswith("'"):
        end = 1
        while True:
            end = text.find("'", end)
            if end < 0:
                raise YAMLError(f"unterminated quoted key: {text!r}")
            if text[end + 1:end + 2] == "'":
                end += 2
                continue
            break
        key_text, rest = text[:end + 1], text[end + 1:]
        if not (rest == ":" or rest.startswith(": ")):
            raise YAMLError(f"not a mapping entry: {text!r}")
    else:
        m = re.search(r":(?: |$)", text)
        if m is None:
            raise YAMLError(f"not a mapping entry: {text!r}")
        key_text, rest = text[:m.start()], text[m.start():]
    key = _scalar(key_text.strip())
    rest = rest[1:].strip()
    return key, (rest if rest else None)


def _is_entry(text: str) -> bool:
    try:
        _split_key(text)
    except YAMLError:
        return False
    return True


def _strip_comment(line: str) -> str:
    """The line without a trailing comment: from a `#` at the start or after
    whitespace, outside quotes. A quote opens a quoted scalar only where a
    token starts."""
    quote = None
    for i, ch in enumerate(line):
        if quote == "'":
            if ch == "'":
                quote = None
        elif quote == '"':
            if ch == "\\":
                quote = '"\\'
            elif ch == '"':
                quote = None
        elif quote == '"\\':
            quote = '"'
        elif ch in "'\"" and (i == 0 or line[i - 1] in " [{,"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


class _Parser:
    def __init__(self, text: str) -> None:
        self.lines: List[Tuple[int, str]] = []
        for raw in text.splitlines():
            if "\t" in raw[: len(raw) - len(raw.lstrip())]:
                raise YAMLError("tabs in indentation")
            body = _strip_comment(raw).rstrip()
            if not body.strip() or body.lstrip().startswith("#"):
                continue
            if body in ("---", "..."):
                if self.lines:
                    raise YAMLError("several documents are not supported")
                continue
            self.lines.append((len(body) - len(body.lstrip()), body.strip()))
        self.i = 0

    def node(self, indent: int) -> Any:
        """The block node whose lines start at indentation `indent`."""
        ind, text = self.lines[self.i]
        if ind != indent:
            raise YAMLError(f"bad indentation at {text!r}")
        if text == "-" or text.startswith("- "):
            return self.sequence(indent)
        if _is_entry(text):
            return self.mapping(indent)
        self.i += 1
        if self.i < len(self.lines) and self.lines[self.i][0] > indent:
            raise YAMLError(f"multi-line scalars are not supported: {text!r}")
        return _value(text)

    def child(self, indent: int, allow_sequence_at_same: bool) -> Any:
        """The value of a key or item that ended its line: the nested block
        below it, or null."""
        if self.i < len(self.lines):
            ind, text = self.lines[self.i]
            if ind > indent:
                return self.node(ind)
            if allow_sequence_at_same and ind == indent and (text == "-" or text.startswith("- ")):
                return self.sequence(indent)
        return None

    def mapping(self, indent: int) -> dict:
        out = {}
        while self.i < len(self.lines):
            ind, text = self.lines[self.i]
            if ind < indent:
                break
            if ind > indent or text.startswith("- "):
                raise YAMLError(f"bad indentation at {text!r}")
            key, rest = _split_key(text)
            if key in out:
                raise YAMLError(f"duplicate key {key!r}")
            self.i += 1
            out[key] = _value(rest) if rest is not None else self.child(indent, True)
        return out

    def sequence(self, indent: int) -> list:
        out = []
        while self.i < len(self.lines):
            ind, text = self.lines[self.i]
            if ind < indent or not (text == "-" or text.startswith("- ")):
                if ind > indent:
                    raise YAMLError(f"bad indentation at {text!r}")
                break
            if ind > indent:
                raise YAMLError(f"bad indentation at {text!r}")
            rest = text[1:].lstrip()
            if not rest:
                self.i += 1
                out.append(self.child(indent, False))
            elif rest.startswith("- ") or rest == "-" or _is_entry(rest):
                # `- - item` or `- key: value` opens a block indented to it
                inner = indent + (len(text) - len(rest))
                self.lines[self.i] = (inner, rest)
                out.append(self.node(inner))
            else:
                self.i += 1
                out.append(_value(rest))
        return out


def load(text: str) -> Any:
    """Parse a document of the subset; an empty document is None."""
    parser = _Parser(text)
    if not parser.lines:
        return None
    out = parser.node(parser.lines[0][0])
    if parser.i != len(parser.lines):
        raise YAMLError(f"unexpected line {parser.lines[parser.i][1]!r}")
    return out


# ----------------------------------------------------------------- writer


def _dump_scalar(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(v, str):
        plain = (v and v == v.strip() and not re.search(r"[:#'\"\[\]{},&*!|>%@`\n]", v)
                 and not v.startswith(("-", "?")))
        if plain:
            try:
                plain = _scalar(v) == v
            except YAMLError:
                plain = False
        return v if plain else "'" + v.replace("'", "''") + "'"
    raise YAMLError(f"cannot write {type(v).__name__}")


def _dump(node: Any, indent: int, out: List[str]) -> None:
    pad = " " * indent
    if isinstance(node, dict):
        for key in sorted(node, key=lambda k: (str(type(k)), k)):
            val = node[key]
            head = f"{pad}{_dump_scalar(key)}:"
            if isinstance(val, dict) and val:
                out.append(head)
                _dump(val, indent + 2, out)
            elif isinstance(val, (list, tuple)) and val:
                out.append(head)
                _dump(list(val), indent, out)
            else:
                out.append(f"{head} {_inline(val)}")
    else:
        for item in node:
            if isinstance(item, dict) and item:
                lines: List[str] = []
                _dump(item, indent + 2, lines)
                out.append(f"{pad}- {lines[0].lstrip()}")
                out.extend(lines[1:])
            elif isinstance(item, (list, tuple)) and item:
                out.append(f"{pad}-")
                _dump(list(item), indent + 2, out)
            else:
                out.append(f"{pad}- {_inline(item)}")


def _inline(v: Any) -> str:
    if isinstance(v, dict):
        return "{}"
    if isinstance(v, (list, tuple)):
        return "[]"
    return _dump_scalar(v)


def dump(data: Any) -> str:
    """A mapping or sequence (of mappings, sequences and scalars) → text."""
    if not isinstance(data, (dict, list, tuple)) or not data:
        return _inline(data) + "\n"
    out: List[str] = []
    _dump(data if isinstance(data, dict) else list(data), 0, out)
    return "\n".join(out) + "\n"
