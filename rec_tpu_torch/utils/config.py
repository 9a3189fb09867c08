"""Frozen-dataclass configs with ``key=value`` command-line overrides (port
of rec_tpu/utils/config.py): dotted paths descend into nested dataclasses,
values are literal-eval'd, and ``true``/``false``/``none`` are accepted."""

from __future__ import annotations

import ast
import dataclasses
from typing import Any, List, Sequence


def _convert(value: str) -> Any:
    low = value.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("none", "null"):
        return None
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        return value


def apply_overrides(cfg: Any, tokens: Sequence[str]) -> Any:
    """Return a copy of ``cfg`` with ``key=value`` / ``a.b=value`` applied.
    Tokens without '=' (e.g. a leading "with") are ignored."""
    for token in tokens:
        if "=" not in token:
            continue
        key, value = token.split("=", 1)
        cfg = _set_path(cfg, key.split("."), _convert(value))
    return cfg


def _set_path(cfg: Any, path: List[str], value: Any) -> Any:
    name = path[0]
    if not hasattr(cfg, name):
        raise KeyError(f"unknown config key {name!r} on {type(cfg).__name__}")
    if len(path) == 1:
        return dataclasses.replace(cfg, **{name: value})
    return dataclasses.replace(
        cfg, **{name: _set_path(getattr(cfg, name), path[1:], value)})


def print_config(cfg: Any, indent: int = 0) -> None:
    pad = "  " * indent
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            print(f"{pad}{f.name}:")
            print_config(v, indent + 1)
        else:
            print(f"{pad}{f.name} = {v!r}")
