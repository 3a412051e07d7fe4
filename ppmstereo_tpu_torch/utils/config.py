"""KEY=VALUE overrides of a dataclass config (counterpart of
ppmstereo_tpu/utils/config.py::apply_overrides, for the flat TrainConfig),
e.g. `log_freq=1` or `crop_size=[64,128]` on the training CLI."""

from __future__ import annotations

import json
from dataclasses import fields
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
    """In-place overrides of a dataclass's fields: ["log_freq=1", ...]; the
    value takes the type of the field's current value."""
    names = {f.name for f in fields(cfg)}
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must be KEY=VALUE: {ov}")
        key, value = ov.split("=", 1)
        if key not in names:
            raise AttributeError(f"{type(cfg).__name__} has no field {key}")
        setattr(cfg, key, _coerce(value, getattr(cfg, key)))
    return cfg
