"""The flat YAML subset of `cfg_files/*.yaml`, read and written without
the `yaml` package.

Reads `key: value` lines at the top level, `#` comments, plain and quoted
scalars and flow lists (`[a, "b,c", [1, 2]]`). Plain scalars resolve as
PyYAML's `safe_load` resolves them (YAML 1.1): null, bool
(yes/no/true/false/on/off), int (decimal, 0o-style octal, hex) and float
only with a dot in the mantissa (`1.0e+8` is a float, `5e2` a string),
`.inf`/`.nan`. Block lists, mappings as values, anchors, multi-line and
sexagesimal scalars are outside the subset and raise.

`dump_yaml` writes a flat dict of scalars and lists in the same subset,
quoting every string, so the result reads back (with this reader or
PyYAML) to the same values.
"""

from __future__ import annotations

import math
import re

_BOOL = {"yes": True, "no": False, "true": True, "false": False,
         "on": True, "off": False}
_NULL = ("", "~", "null", "Null", "NULL")
_INT_DEC = re.compile(r"^[-+]?(0|[1-9][0-9_]*)$")
_INT_OCT = re.compile(r"^[-+]?0[0-7_]+$")
_INT_HEX = re.compile(r"^[-+]?0x[0-9a-fA-F_]+$")
_INT_BIN = re.compile(r"^[-+]?0b[0-1_]+$")
_SEXAGESIMAL = re.compile(r"^[-+]?[0-9][0-9_]*(:[0-5]?[0-9])+(\.[0-9_]*)?$")
_FLOAT = re.compile(r"^([-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?"
                    r"|[-+]?\.(inf|Inf|INF)|\.(nan|NaN|NAN))$")


def _bool_word(s: str):
    if s in ("yes", "Yes", "YES", "no", "No", "NO", "true", "True", "TRUE",
             "false", "False", "FALSE", "on", "On", "ON", "off", "Off",
             "OFF"):
        return _BOOL[s.lower()]
    return None


def resolve_plain(s: str):
    """A plain (unquoted) scalar -> its YAML 1.1 value."""
    if s in _NULL:
        return None
    if _SEXAGESIMAL.match(s):
        raise ValueError(f"sexagesimal scalar {s!r} is outside the subset")
    b = _bool_word(s)
    if b is not None:
        return b
    sign = -1 if s.startswith("-") else 1
    body = s.lstrip("+-").replace("_", "")
    if _INT_BIN.match(s):
        return sign * int(body[2:], 2)
    if _INT_HEX.match(s):
        return sign * int(body[2:], 16)
    if _INT_OCT.match(s):
        return sign * int(body, 8)
    if _INT_DEC.match(s):
        return sign * int(body)
    if _FLOAT.match(s) and s not in (".", "-.", "+."):
        low = body.lower()
        if low == ".inf":
            return sign * math.inf
        if low == ".nan":
            return math.nan
        return sign * float(body)
    return s


def _strip_comment(line: str) -> str:
    """Drop a `#` comment that is outside quotes and follows a space."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
            elif ch == "\\" and quote == '"':
                continue
        elif ch in "\"'":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


class _Parser:
    def __init__(self, text: str):
        self.s = text
        self.i = 0

    def ws(self):
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def value(self, in_list: bool):
        self.ws()
        if self.i >= len(self.s):
            return None
        ch = self.s[self.i]
        if ch == "[":
            return self.flow_list()
        if ch in "\"'":
            return self.quoted(ch)
        if ch in "{&*!|>":
            raise ValueError(f"YAML construct {ch!r} is outside the subset: "
                             f"{self.s!r}")
        stop = ",]" if in_list else ""
        j = self.i
        while j < len(self.s) and self.s[j] not in stop:
            j += 1
        tok = self.s[self.i:j].strip()
        self.i = j
        return resolve_plain(tok)

    def quoted(self, q: str) -> str:
        self.i += 1
        out = []
        while self.i < len(self.s):
            ch = self.s[self.i]
            if q == "'" and ch == "'":
                if self.s[self.i + 1:self.i + 2] == "'":
                    out.append("'")
                    self.i += 2
                    continue
                self.i += 1
                return "".join(out)
            if q == '"' and ch == "\\":
                nxt = self.s[self.i + 1]
                out.append({"n": "\n", "t": "\t", '"': '"', "\\": "\\",
                            "/": "/"}.get(nxt, "\\" + nxt))
                self.i += 2
                continue
            if q == '"' and ch == '"':
                self.i += 1
                return "".join(out)
            out.append(ch)
            self.i += 1
        raise ValueError(f"unterminated quoted scalar: {self.s!r}")

    def flow_list(self) -> list:
        self.i += 1
        items = []
        self.ws()
        if self.s[self.i:self.i + 1] == "]":
            self.i += 1
            return items
        while True:
            items.append(self.value(in_list=True))
            self.ws()
            ch = self.s[self.i:self.i + 1]
            self.i += 1
            if ch == "]":
                return items
            if ch != ",":
                raise ValueError(f"malformed flow list: {self.s!r}")
            self.ws()
            if self.s[self.i:self.i + 1] == "]":   # trailing comma
                self.i += 1
                return items


def load_yaml(text: str) -> dict | None:
    """Parse a flat `key: value` document; None for an empty one."""
    out: dict = {}
    for raw in text.splitlines():
        line = _strip_comment(raw).rstrip()
        if not line.strip() or line.strip() in ("---", "..."):
            continue
        if line[0] in " \t-":
            raise ValueError(f"nested or block YAML is outside the subset: "
                             f"{raw!r}")
        m = re.match(r"^([A-Za-z_][A-Za-z0-9_]*)\s*:(\s+|$)", line)
        if not m:
            raise ValueError(f"not a `key: value` line: {raw!r}")
        p = _Parser(line[m.end():])
        val = p.value(in_list=False)
        p.ws()
        if p.i != len(p.s):
            raise ValueError(f"trailing text after the value: {raw!r}")
        out[m.group(1)] = val
    return out or None


def _dump_scalar(v) -> str:
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
        r = repr(v)
        if "e" in r and "." not in r.split("e")[0]:
            mant, exp = r.split("e")
            r = f"{mant}.0e{exp}"
        return r
    if isinstance(v, str):
        return '"' + v.replace("\\", "\\\\").replace('"', '\\"') + '"'
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_dump_scalar(x) for x in v) + "]"
    raise TypeError(f"cannot write {type(v).__name__} in the YAML subset")


def dump_yaml(d: dict) -> str:
    """A flat dict -> YAML text in the subset, keys sorted as
    `yaml.safe_dump` sorts them."""
    return "".join(f"{k}: {_dump_scalar(d[k])}\n" for k in sorted(d))
