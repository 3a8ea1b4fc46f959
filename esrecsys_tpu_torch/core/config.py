"""Single config system (counterpart of ``esrecsys_tpu/core/config.py``).

One dataclass per workload is the single source of truth; CLI parsing
(``--field value``) and sweep-dict overrides both land in the same
object.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import typing
from typing import Any, Dict, Mapping, Type, TypeVar, get_args, get_origin

T = TypeVar("T")


def _parse_value(field_type: Any, raw: str) -> Any:
    origin = get_origin(field_type)
    if origin in (list, tuple):
        inner = get_args(field_type)[0] if get_args(field_type) else str
        vals = [inner(v) for v in raw.split(",") if v != ""]
        return tuple(vals) if origin is tuple else vals
    if field_type is bool:
        return raw.lower() in ("1", "true", "yes", "on")
    return field_type(raw)


def from_cli(cls: Type[T], argv=None, **overrides) -> T:
    """Build a config dataclass from CLI args (``--field value``);
    arguments that name no field are left for other parsers."""
    parser = argparse.ArgumentParser(description=cls.__doc__)
    for f in dataclasses.fields(cls):
        parser.add_argument(f"--{f.name}", type=str, default=None,
                            help=str(f.type))
    ns, _ = parser.parse_known_args(argv)
    hints = typing.get_type_hints(cls)
    kwargs: Dict[str, Any] = {}
    for f in dataclasses.fields(cls):
        raw = getattr(ns, f.name)
        if raw is not None:
            kwargs[f.name] = _parse_value(hints[f.name], raw)
    kwargs.update(overrides)
    return cls(**kwargs)


def with_overrides(cfg: T, overrides: Mapping[str, Any]) -> T:
    """Apply a sweep/override dict, returning a new config."""
    valid = {f.name for f in dataclasses.fields(cfg)}
    unknown = set(overrides) - valid
    if unknown:
        raise ValueError(f"unknown config keys: {sorted(unknown)}")
    return dataclasses.replace(cfg, **dict(overrides))


def to_dict(cfg: Any) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


def save(cfg: Any, path: str) -> None:
    with open(path, "w") as f:
        json.dump(to_dict(cfg), f, indent=2, default=str)


def load(cls: Type[T], path: str) -> T:
    with open(path) as f:
        d = json.load(f)
    field_names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in d.items() if k in field_names})
