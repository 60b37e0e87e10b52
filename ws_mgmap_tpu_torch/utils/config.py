"""Minimal yacs-compatible config node, and the YAML subset its files use.

The port's copy of ``ws_mgmap_tpu/utils/config.py``. The reference stack
builds a three-level frozen config tree with yacs
(``vlnce_baselines/config/default.py:155-181``, habitat's ``Config``).  We
re-provide the same public surface (attribute access, ``merge_from_file``,
``merge_from_list``, ``clone``, ``freeze``/``defrost``) without depending on
yacs or habitat.

The JAX package reads YAML with PyYAML. The port reads it with ``loads``
below, the same on every machine, so it needs no PyYAML. It reads the
subset the port's YAMLs and command-line values use: block mappings of
identifier keys nested by indentation, one-line ``[...]`` lists of
scalars, plain scalars typed as PyYAML's ``safe_load`` types them (YAML
1.1 null and bool, decimal int and float, str), quoted scalars without
escapes, and ``#`` comments. Anything else raises ``YAMLSubsetError``,
also a plain scalar that starts like a number but is not a decimal one
(``0x10``, ``1e-4``, ``1_000``, dates): PyYAML types those in ways the
subset does not copy.
"""
from __future__ import annotations

import copy
import re
from typing import Any, Dict, List, Optional


class Config(dict):
    """A nested, freezable dict with attribute access (yacs CfgNode surface)."""

    _FROZEN_KEY = "__frozen__"

    def __init__(self, init: Optional[Dict[str, Any]] = None):
        super().__init__()
        object.__setattr__(self, "_frozen", False)
        if init:
            for k, v in init.items():
                self[k] = Config(v) if isinstance(v, dict) else v

    # -- attribute protocol -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, "_frozen"):
            raise AttributeError(f"Config is frozen; cannot set {name}")
        if isinstance(value, dict) and not isinstance(value, Config):
            value = Config(value)
        self[name] = value

    def __setitem__(self, key, value):
        if object.__getattribute__(self, "_frozen"):
            raise AttributeError(f"Config is frozen; cannot set {key}")
        super().__setitem__(key, value)

    # -- yacs surface --------------------------------------------------------
    def clone(self) -> "Config":
        out = Config()
        for k, v in self.items():
            out[k] = v.clone() if isinstance(v, Config) else copy.deepcopy(v)
        return out

    def freeze(self) -> None:
        object.__setattr__(self, "_frozen", True)
        for v in self.values():
            if isinstance(v, Config):
                v.freeze()

    def defrost(self) -> None:
        object.__setattr__(self, "_frozen", False)
        for v in self.values():
            if isinstance(v, Config):
                v.defrost()

    def is_frozen(self) -> bool:
        return object.__getattribute__(self, "_frozen")

    def merge_from_other_cfg(self, other: "Config") -> None:
        for k, v in other.items():
            if isinstance(v, dict) and isinstance(self.get(k), Config):
                self[k].merge_from_other_cfg(v if isinstance(v, Config) else Config(v))
            else:
                self[k] = Config(v) if isinstance(v, dict) else v

    def merge_from_file(self, path: str) -> None:
        with open(path, "r") as f:
            loaded = loads(f.read()) or {}
        self.merge_from_other_cfg(Config(loaded))

    def merge_from_list(self, opts: List[Any]) -> None:
        assert len(opts) % 2 == 0, f"Override list must be key/value pairs: {opts}"
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = str(key).split(".")
            for p in parts[:-1]:
                if p not in node:
                    node[p] = Config()
                node = node[p]
            node[parts[-1]] = _coerce(value, node.get(parts[-1]))

    def to_dict(self) -> Dict[str, Any]:
        return {
            k: (v.to_dict() if isinstance(v, Config) else v) for k, v in self.items()
        }

    def __deepcopy__(self, memo):
        return self.clone()

    def __reduce__(self):
        # dict-subclass pickling bypasses __init__; rebuild from plain dicts
        # (unpickled configs come back unfrozen, which env workers rely on).
        return (Config, (self.to_dict(),))


def _coerce(value: Any, old: Any) -> Any:
    """Coerce a CLI string to the type of the existing value (yacs behavior)."""
    if not isinstance(value, str):
        return value
    parsed = loads(value)  # a value outside the subset raises
    if old is not None and isinstance(old, str) and not isinstance(parsed, str):
        # keep strings that look like numbers if the default was a string
        return value
    return parsed


CN = Config




# ---------------------------------------------------------------------------
# The YAML subset
# ---------------------------------------------------------------------------
class YAMLSubsetError(ValueError):
    """Text outside the YAML subset that ``loads`` reads."""


_KEY = re.compile(r"([A-Za-z_][A-Za-z0-9_]*):(?=[ \t]|$)")
# PyYAML's YAML 1.1 resolvers (``yaml/resolver.py``), cut to the subset
_NULL = {"", "~", "null", "Null", "NULL"}
_BOOL = {"yes": True, "Yes": True, "YES": True, "no": False, "No": False,
         "NO": False, "true": True, "True": True, "TRUE": True,
         "false": False, "False": False, "FALSE": False, "on": True,
         "On": True, "ON": True, "off": False, "Off": False, "OFF": False}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)")
_FLOAT = re.compile(r"[-+]?[0-9]+\.[0-9]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9]+(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)")
# starts like a number: a decimal int or float above, or refused (PyYAML
# types hex, octal, 1_000, sexagesimal and dates, and 1e-4 as a str)
_NUMERIC = re.compile(r"[-+]?(?:[0-9]|\.[0-9_])")
# a plain scalar may not start with these (YAML 1.1 indicators)
_INDICATORS = "-?:,[]{}#&*!|>'\"%@`"


def _scalar(text: str, where: str) -> Any:
    """A plain scalar as PyYAML's ``safe_load`` types it."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.fullmatch(text):
        return int(text)
    if _FLOAT.fullmatch(text):
        return float(text.lower().replace(".inf", "inf")
                     .replace(".nan", "nan"))
    if _NUMERIC.match(text) or text in ("<<", "="):  # "<<", "=": tags
        raise YAMLSubsetError(f"{where}: {text!r} is not in the subset")
    return text


def _plain(text: str, where: str, flow: bool = False) -> Any:
    if not text or (text[0] in _INDICATORS and not (
            text[0] in "-?:" and text[1:2] not in ("", " ", "\t"))):
        raise YAMLSubsetError(f"{where}: {text!r} is not a plain scalar")
    if (": " in text or text.endswith(":")
            or (flow and any(ch in text for ch in "[]{}#"))):
        raise YAMLSubsetError(f"{where}: {text!r} is not in the subset")
    return _scalar(text, where)


def _quoted(s: str, where: str) -> tuple:
    """The quoted scalar at the start of ``s`` and the text after it."""
    q, i, parts = s[0], 1, []
    while True:
        j = s.find(q, i)
        if j < 0:
            raise YAMLSubsetError(f"{where}: unterminated {s!r}")
        if q == "'" and s[j + 1:j + 2] == "'":  # '' is a quote
            parts.append(s[i:j + 1])
            i = j + 2
            continue
        text = "".join(parts) + s[i:j]
        if q == '"' and "\\" in text:
            raise YAMLSubsetError(f"{where}: escapes are not in the subset")
        return text, s[j + 1:]


def _end(rest: str, where: str) -> None:
    """Nothing but blanks and a comment may follow a value."""
    if rest.strip(" \t") and not (rest[0] in " \t"
                                  and rest.lstrip(" \t")[0] == "#"):
        raise YAMLSubsetError(f"{where}: trailing text {rest!r}")


def _value(s: str, where: str) -> Any:
    """The value a line holds from ``s`` on: a quoted scalar, a one-line
    list of scalars, or a plain scalar up to a comment."""
    if s[0] in "'\"":
        text, rest = _quoted(s, where)
        _end(rest, where)
        return text
    if s[0] != "[":
        cut = re.search(r"[ \t]#", s)
        return _plain((s[:cut.start()] if cut else s).rstrip(" \t"), where)
    items, rest = [], s[1:].lstrip(" \t")
    while not rest.startswith("]"):
        if rest[:1] in ("'", '"'):
            item, rest = _quoted(rest, where)
        else:
            stop = re.search(r"[,\]]", rest)
            if not stop:
                raise YAMLSubsetError(f"{where}: a list must end on its line")
            item = _plain(rest[:stop.start()].strip(" \t"), where, flow=True)
            rest = rest[stop.start():]
        items.append(item)
        rest = rest.lstrip(" \t")
        if rest.startswith(","):
            rest = rest[1:].lstrip(" \t")
            if rest.startswith("]"):
                raise YAMLSubsetError(f"{where}: empty list item in {s!r}")
        elif not rest.startswith("]"):
            raise YAMLSubsetError(f"{where}: expected ',' or ']' in {s!r}")
    _end(rest[1:], where)
    return items


def loads(text: str) -> Any:
    """Parse a document of the subset; ``None`` for an empty one."""
    lines = []
    for number, raw in enumerate(text.splitlines(), 1):
        body = raw.lstrip(" ")
        if not body.strip() or body.startswith("#"):
            continue
        if body[0] == "\t" or body.rstrip() in ("---", "..."):
            raise YAMLSubsetError(f"line {number}: not in the subset: "
                                  f"{raw!r}")
        lines.append((len(raw) - len(body), body.rstrip(" \t"),
                      f"line {number}"))
    if not lines:
        return None
    if not _KEY.match(lines[0][1]):  # a one-line scalar or list
        if len(lines) > 1:
            raise YAMLSubsetError("multi-line scalars are not in the subset")
        return _value(lines[0][1], lines[0][2])
    tree, i = _mapping(lines, 0, lines[0][0])
    if i < len(lines):
        raise YAMLSubsetError(f"{lines[i][2]}: bad indentation")
    return tree


def _mapping(lines, i: int, indent: int) -> tuple:
    """The block mapping whose keys sit at column ``indent``, from line
    ``i``; returns it and the index of the first line after it."""
    out: Dict[str, Any] = {}
    while i < len(lines) and lines[i][0] == indent:
        _, body, where = lines[i]
        m = _KEY.match(body)
        if not m or not isinstance(_scalar(m.group(1), where), str):
            raise YAMLSubsetError(f"{where}: expected 'key:' (block "
                                  f"sequences are not in the subset): "
                                  f"{body!r}")
        rest = body[m.end():].lstrip(" \t")
        i += 1
        nested = i < len(lines) and lines[i][0] > indent
        if rest and rest[0] != "#":
            if nested:
                raise YAMLSubsetError(f"{lines[i][2]}: multi-line scalars "
                                      "are not in the subset")
            out[m.group(1)] = _value(rest, where)
        elif nested:
            out[m.group(1)], i = _mapping(lines, i, lines[i][0])
        else:
            out[m.group(1)] = None
    if i < len(lines) and lines[i][0] > indent:
        raise YAMLSubsetError(f"{lines[i][2]}: bad indentation")
    return out, i
