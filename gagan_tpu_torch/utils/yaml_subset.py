"""A reader and writer for the subset of YAML that ``configs/*.yaml`` use,
so the port needs no PyYAML.

The subset: block maps nested by indentation with plain keys, flow
sequences ``[a, b]`` of scalars, empty flow maps ``{}``, ``#`` comments, and scalars resolved as PyYAML's ``safe_load`` resolves them
(YAML 1.1: ``null`` / ``~``, ``true`` / ``yes`` / ``on`` and their
negations, decimal and hex ints, floats that have a dot or ``.inf`` /
``.nan``, else strings; single- or double-quoted strings stay strings).
Anything outside the subset (block sequences, anchors, multi-line strings,
nested flow collections, several documents) raises ``ValueError`` naming
the line.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Tuple

_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TRUE = re.compile(r"^(?:yes|Yes|YES|true|True|TRUE|on|On|ON)$")
_FALSE = re.compile(r"^(?:no|No|NO|false|False|FALSE|off|Off|OFF)$")
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_HEX = re.compile(r"^[-+]?0x[0-9a-fA-F_]+$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?)$")
_INF = re.compile(r"^[-+]?\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"^\.(?:nan|NaN|NAN)$")
# A plain string the writer may leave unquoted.
_SAFE_PLAIN = re.compile(r"^[A-Za-z0-9_./][A-Za-z0-9_./+\- ]*$")


def _resolve(text: str) -> Any:
    if _NULL.match(text):
        return None
    if _TRUE.match(text):
        return True
    if _FALSE.match(text):
        return False
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _HEX.match(text):
        return int(text.replace("_", ""), 16)
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if _INF.match(text):
        return -math.inf if text.startswith("-") else math.inf
    if _NAN.match(text):
        return math.nan
    return text


def _unquote(text: str, where: str) -> str:
    if text[0] == "'":
        if len(text) < 2 or text[-1] != "'":
            raise ValueError(f"{where}: unterminated quoted string")
        return text[1:-1].replace("''", "'")
    if len(text) < 2 or text[-1] != '"':
        raise ValueError(f"{where}: unterminated quoted string")
    out, i, body = [], 0, text[1:-1]
    escapes = {"\\": "\\", '"': '"', "n": "\n", "t": "\t", "0": "\0",
               "/": "/"}
    while i < len(body):
        ch = body[i]
        if ch == "\\":
            if i + 1 >= len(body) or body[i + 1] not in escapes:
                raise ValueError(f"{where}: unsupported escape in {text}")
            out.append(escapes[body[i + 1]])
            i += 2
        else:
            out.append(ch)
            i += 1
    return "".join(out)


def _scalar(text: str, where: str) -> Any:
    text = text.strip()
    if text[:1] in ("'", '"'):
        return _unquote(text, where)
    if text[:1] in ("&", "*", "!", "|", ">", "%", "@", "`", "{", "["):
        raise ValueError(f"{where}: {text!r} is outside the YAML subset")
    return _resolve(text)


def _escaped(text: str, i: int, quote: str) -> bool:
    """Whether the double quote at text[i] is escaped by backslashes."""
    if quote != '"':
        return False
    n = 0
    while i - n - 1 >= 0 and text[i - n - 1] == "\\":
        n += 1
    return n % 2 == 1


def _strip_comment(line: str) -> str:
    """The line without a ``#`` comment (one at the start or after a blank,
    outside quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote and not _escaped(line, i, quote):
                quote = None
        elif ch in ("'", '"') and (i == 0 or line[i - 1] in " [,:"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _split_flow(body: str, where: str) -> List[str]:
    items, cur, quote = [], [], None
    for i, ch in enumerate(body):
        if quote:
            cur.append(ch)
            if ch == quote and not _escaped(body, i, quote):
                quote = None
        elif ch in ("'", '"'):
            quote = ch
            cur.append(ch)
        elif ch == ",":
            items.append("".join(cur))
            cur = []
        elif ch in "[]{}":
            raise ValueError(f"{where}: nested flow collections are outside "
                             f"the YAML subset")
        else:
            cur.append(ch)
    last = "".join(cur)
    if last.strip() or items:
        items.append(last)
    if any(not item.strip() for item in items):
        raise ValueError(f"{where}: empty item in a flow sequence")
    return items


def _value(text: str, where: str) -> Any:
    text = text.strip()
    if text.startswith("["):
        if not text.endswith("]"):
            raise ValueError(f"{where}: unterminated flow sequence")
        return [_scalar(item, where)
                for item in _split_flow(text[1:-1], where)]
    if text == "{}":
        return {}
    return _scalar(text, where)


def _split_key(content: str, where: str) -> Tuple[str, str]:
    """'key: value' -> (key, value) for a plain key."""
    m = re.match(r"^([^:#'\"\[{&*!|>%@`-][^:#]*?):(?:\s|$)(.*)$", content)
    if not m:
        raise ValueError(f"{where}: expected 'key: value' with a plain key")
    return m.group(1), m.group(2)


def load(text: str) -> Dict[str, Any]:
    """Parse ``text`` (the subset above) into a dict; an empty document is
    an empty dict."""
    lines = []
    for number, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise ValueError(f"line {number}: tab in the indentation")
        line = _strip_comment(raw).rstrip()
        if line.strip() in ("---", "..."):
            if lines:
                raise ValueError(f"line {number}: one document only")
            continue
        if line.strip():
            lines.append((number, len(line) - len(line.lstrip()),
                          line.strip()))
    if not lines:
        return {}
    value, end = _block(lines, 0, lines[0][1])
    if end != len(lines):
        raise ValueError(f"line {lines[end][0]}: unexpected indentation")
    return value


def _block(lines, i: int, indent: int):
    """The block map starting at lines[i] at ``indent``; returns (map,
    index after it)."""
    out: Dict[str, Any] = {}
    while i < len(lines) and lines[i][1] == indent:
        number, _, content = lines[i]
        where = f"line {number}"
        key, rest = _split_key(content, where)
        if key in out:
            raise ValueError(f"{where}: duplicate key {key!r}")
        i += 1
        if rest.strip():
            out[key] = _value(rest, where)
        elif i < len(lines) and lines[i][1] > indent:
            out[key], i = _block(lines, i, lines[i][1])
        else:
            out[key] = None
    if i < len(lines) and lines[i][1] > indent:
        raise ValueError(f"line {lines[i][0]}: unexpected indentation")
    return out, i


def _format_scalar(value: Any) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value)
        if "." not in text:                       # 1e-05 -> 1.0e-05
            text = text.replace("e", ".0e")
        return text
    if isinstance(value, str):
        if _SAFE_PLAIN.match(value) and not value.endswith(" ") \
                and isinstance(_resolve(value), str):
            return value
        return "'" + value.replace("'", "''") + "'"
    raise ValueError(f"{value!r} ({type(value).__name__}) is outside the "
                     f"YAML subset")


def dump(data: Dict[str, Any]) -> str:
    """``data`` (nested dicts of scalars and flat lists of scalars) as text
    that :func:`load` and PyYAML read back equal; keys in their order."""
    out: List[str] = []

    def emit(node: Dict[str, Any], indent: int):
        for key, value in node.items():
            if _format_scalar(str(key)) != str(key):
                raise ValueError(f"key {key!r} is not a plain YAML key")
            head = " " * indent + str(key) + ":"
            if isinstance(value, dict) and value:
                out.append(head)
                emit(value, indent + 2)
            elif isinstance(value, dict):
                out.append(head + " {}")
            elif isinstance(value, (list, tuple)):
                out.append(head + " [" + ", ".join(
                    _format_scalar(item) for item in value) + "]")
            else:
                out.append(head + " " + _format_scalar(value))

    emit(data, 0)
    return "\n".join(out) + "\n"


def read(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return load(f.read())


def write(path: str, data: Dict[str, Any]):
    with open(path, "w") as f:
        f.write(dump(data))
