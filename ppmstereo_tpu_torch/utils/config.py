"""Dataclass configs from YAML presets and KEY=VALUE overrides (counterpart
of ppmstereo_tpu/utils/config.py): `MODEL.iters=20` on the evaluate CLI,
`log_freq=1` or `crop_size=[64,128]` on the training CLI.

`load_yaml` parses the subset of YAML that the presets use, without PyYAML:
nested mappings by indentation, `#` comments, and int, float, bool, null
and plain or quoted string scalars. Anything else (lists, flow collections,
anchors, multi-line strings, tabs) raises, naming the line.
"""

from __future__ import annotations

import dataclasses
import json
import re
from dataclasses import fields, is_dataclass
from typing import Any


def _coerce(value: str, current: Any) -> Any:
    if isinstance(current, bool):
        return value.lower() in ("1", "true", "yes", "on")
    if isinstance(current, int):
        return int(value)
    if isinstance(current, float):
        return float(value)
    if isinstance(current, (tuple, list)):
        items = json.loads(value) if value.startswith("[") else value.split(",")
        return type(current)(items)
    return value


def apply_overrides(cfg: Any, overrides: list[str]) -> Any:
    """In-place overrides of a (nested) dataclass's fields by dotted path:
    ["MODEL.iters=20", "log_freq=1", ...]; the value takes the type of the
    field's current value."""
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must be KEY=VALUE: {ov}")
        key, value = ov.split("=", 1)
        *parents, leaf = key.split(".")
        node = cfg
        for p in parents:
            node = getattr(node, p)
        if leaf not in {f.name for f in fields(node)}:
            raise AttributeError(f"{type(node).__name__} has no field {leaf}")
        setattr(node, leaf, _coerce(value, getattr(node, leaf)))
    return cfg


def from_dict(cls, data: dict):
    """A (nested) dataclass from a plain dict; a nested mapping updates the
    field's default dataclass."""
    kwargs = {}
    known = {f.name: f for f in fields(cls)}
    for k, v in data.items():
        if k not in known:
            raise KeyError(f"{cls.__name__} has no field {k}")
        f = known[k]
        default = (f.default_factory() if f.default_factory is not dataclasses.MISSING
                   else f.default)
        if is_dataclass(default) and isinstance(v, dict):
            kwargs[k] = dataclasses.replace(default, **v)
        else:
            kwargs[k] = v
    return cls(**kwargs)


_KEY = re.compile(r"^([A-Za-z_][A-Za-z0-9_.-]*)\s*:(?:\s+(.*))?$")
# PyYAML's (YAML 1.1) resolvers, decimal ints only
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_OTHER_INT = re.compile(r"^[-+]?(?:0b[0-1_]+|0[0-7_]+|0x[0-9a-fA-F_]+|[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?)$")
_INF = re.compile(r"^[-+]?\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"^\.(?:nan|NaN|NAN)$")
_BOOLS = {**dict.fromkeys(("true", "True", "TRUE", "yes", "Yes", "YES", "on", "On", "ON"), True),
          **dict.fromkeys(("false", "False", "FALSE", "no", "No", "NO", "off", "Off", "OFF"),
                          False)}


def _strip_comment(text: str) -> str:
    """The line without a `#` comment outside quotes."""
    quote = None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i]
    return text


def _scalar(text: str, where: str) -> Any:
    """A plain or quoted scalar, read as yaml.safe_load reads it."""
    if text[:1] in "'\"":
        q = text[0]
        if len(text) < 2 or text[-1] != q:
            raise ValueError(f"{where}: unterminated string {text!r}")
        body = text[1:-1]
        if q == '"' and "\\" in body:
            raise ValueError(f"{where}: escapes in double-quoted strings are not supported")
        return body.replace("''", "'") if q == "'" else body
    if (text[:1] in "[]{}&*!|>%@`,?-" and not _INT.match(text) and not _FLOAT.match(text)
            and not _INF.match(text)) or _OTHER_INT.match(text) or ": " in text:
        raise ValueError(f"{where}: {text!r} is outside the supported YAML subset "
                         "(nested mappings of scalars)")
    if text in _BOOLS:
        return _BOOLS[text]
    if text in ("null", "Null", "NULL", "~"):
        return None
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if _INF.match(text):
        return float("-inf") if text[0] == "-" else float("inf")
    if _NAN.match(text):
        return float("nan")
    return text


def parse_yaml(text: str, source: str = "<yaml>") -> dict:
    """A mapping from the supported YAML subset (see the module docstring)."""
    root: dict = {}
    stack: list = [[None, root]]  # [indent, mapping], the root's set by its first key
    pending = None  # (indent, mapping, key) of a key with no value on its line
    for n, raw in enumerate(text.splitlines(), start=1):
        where = f"{source}:{n}"
        line = _strip_comment(raw).rstrip()
        body = line.lstrip(" ")
        if not body or body in ("---", "..."):
            continue
        if body[0] == "\t" or "\t" in line[:len(line) - len(body)]:
            raise ValueError(f"{where}: tabs in indentation are not supported")
        indent = len(line) - len(body)
        m = _KEY.match(body)
        if not m:
            raise ValueError(f"{where}: expected 'key: value', got {body!r}")
        key, value = m.group(1), (m.group(2) or "").strip()
        if pending is not None:
            p_indent, p_mapping, p_key = pending
            pending = None
            if indent > p_indent:  # the key above opens a nested mapping
                p_mapping[p_key] = {}
                stack.append([indent, p_mapping[p_key]])
        if stack[0][0] is None:
            stack[0][0] = indent
        while len(stack) > 1 and indent < stack[-1][0]:
            stack.pop()
        if indent != stack[-1][0]:
            raise ValueError(f"{where}: inconsistent indentation")
        mapping = stack[-1][1]
        if key in mapping:
            raise ValueError(f"{where}: duplicate key {key!r}")
        mapping[key] = _scalar(value, where) if value else None
        if not value:
            pending = (indent, mapping, key)
    return root


def load_yaml(cls, path: str, overrides: list[str] | None = None):
    """A dataclass `cls` from a YAML preset, then the overrides."""
    with open(path) as f:
        data = parse_yaml(f.read(), path)
    cfg = from_dict(cls, data)
    if overrides:
        apply_overrides(cfg, overrides)
    return cfg


def to_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)
