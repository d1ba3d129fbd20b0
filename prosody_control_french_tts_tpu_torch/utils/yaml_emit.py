"""A small YAML emitter for the run's ``used_config.yaml``.

It writes what ``yaml.dump(data, default_flow_style=False,
allow_unicode=True)`` writes for a configuration tree, byte for byte,
without PyYAML (which the pipeline does not otherwise need): block
mappings with sorted string keys, block sequences at their key's
indentation, plain scalars where PyYAML's resolver and scalar analysis
allow them, single quotes otherwise, and PyYAML's spelling of numbers,
booleans and null. What it cannot write the same way (multi-line or
control-character strings, lines PyYAML would fold past 80 columns,
non-string keys, other types) raises.
"""

from __future__ import annotations

import math
import re

_WIDTH = 80

# PyYAML's implicit resolvers: a plain scalar matching one of these would
# read back as something other than a string, so such strings are quoted
_IMPLICIT = [
    re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF)$"),
    re.compile(
        r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
        r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$"
    ),
    re.compile(
        r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)|[-+]?0x[0-9a-fA-F_]+"
        r"|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$"
    ),
    re.compile(r"^(?:<<)$"),
    re.compile(r"^(?:~|null|Null|NULL|)$"),
    re.compile(
        r"^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]|[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?"
        r"(?:[Tt]|[ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?"
        r"(?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$"
    ),
    re.compile(r"^(?:=)$"),
]


def _plain_ok(s: str) -> bool:
    """PyYAML's ``allow_block_plain`` for a one-line printable string."""
    if not s or s[0] == " " or s[-1] == " " or s.startswith(("---", "...")):
        return False
    for i, ch in enumerate(s):
        followed_by_space = i + 1 == len(s) or s[i + 1] == " "
        if i == 0:
            if ch in "#,[]{}&*!|>'\"%@`":
                return False
            if ch in "?:-" and followed_by_space:
                return False
        else:
            if ch == ":" and followed_by_space:
                return False
            if ch == "#" and s[i - 1] == " ":
                return False
    return not any(p.match(s) for p in _IMPLICIT)


def _string(s: str, column: int) -> str:
    if any(ch in "\n\r\x85\u2028\u2029\ufeff\x7f" or (ord(ch) < 0x20 and ch != "\t") for ch in s):
        raise ValueError(f"yaml_emit: cannot write {s!r} as PyYAML does (line break or control character)")
    if "\t" in s:
        raise ValueError(f"yaml_emit: cannot write {s!r} as PyYAML does (tab)")
    out = s if _plain_ok(s) else "'" + s.replace("'", "''") + "'"
    if " " in s and column + len(out) > _WIDTH:
        raise ValueError(f"yaml_emit: {s!r} would be folded past {_WIDTH} columns")
    return out


def _scalar(v, column: int) -> str:
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
        r = repr(v).lower()
        if "." not in r and "e" in r:
            r = r.replace("e", ".0e", 1)
        return r
    if isinstance(v, str):
        return _string(v, column)
    if isinstance(v, dict) and not v:
        return "{}"
    if isinstance(v, list) and not v:
        return "[]"
    raise TypeError(f"yaml_emit: cannot write a {type(v).__name__}")


def _mapping(d: dict, indent: int) -> list[str]:
    if not all(isinstance(k, str) for k in d):
        raise TypeError("yaml_emit: mapping keys must be strings")
    out = []
    for k in sorted(d):
        v = d[k]
        key = " " * indent + _string(k, indent) + ":"
        if isinstance(v, dict) and v:
            out.append(key)
            out += _mapping(v, indent + 2)
        elif isinstance(v, list) and v:
            out.append(key)
            out += _sequence(v, indent)
        else:
            out.append(key + " " + _scalar(v, len(key) + 1))
    return out


def _sequence(items: list, indent: int) -> list[str]:
    out = []
    pad = " " * indent + "- "
    for v in items:
        if isinstance(v, dict) and v:
            sub = _mapping(v, indent + 2)
        elif isinstance(v, list) and v:
            sub = _sequence(v, indent + 2)
        else:
            out.append(pad + _scalar(v, len(pad)))
            continue
        out.append(pad + sub[0][indent + 2 :])
        out += sub[1:]
    return out


def dump(data: dict) -> str:
    """The text of ``yaml.dump(data, default_flow_style=False,
    allow_unicode=True)`` for a configuration tree (a dict)."""
    if not isinstance(data, dict):
        raise TypeError("yaml_emit: a configuration tree is a dict")
    return "\n".join(_mapping(data, 0) if data else ["{}"]) + "\n"
