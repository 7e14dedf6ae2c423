"""Frozen-dataclass config base with dict/JSON round-trip (a copy of
:mod:`repro.common.config`).

Configs are immutable; ``replace`` returns an updated copy.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Type, TypeVar

T = TypeVar("T", bound="Config")


@dataclasses.dataclass(frozen=True)
class Config:
    """Base class of the port's configs."""

    def replace(self: T, **kw: Any) -> T:
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> Dict[str, Any]:
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, Config):
                v = v.to_dict()
            elif isinstance(v, tuple):
                v = [x.to_dict() if isinstance(x, Config) else x for x in v]
            out[f.name] = v
        return out

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls: Type[T], d: Dict[str, Any]) -> T:
        kw = {}
        for f in dataclasses.fields(cls):
            if f.name not in d:
                continue
            v = d[f.name]
            ft = f.type
            if isinstance(ft, str):
                ft = None  # forward reference: trust the raw value
            if (ft is not None and isinstance(ft, type)
                    and issubclass(ft, Config) and isinstance(v, dict)):
                v = ft.from_dict(v)
            elif isinstance(v, list):
                v = tuple(v)
            kw[f.name] = v
        return cls(**kw)

    @classmethod
    def from_json(cls: Type[T], s: str) -> T:
        return cls.from_dict(json.loads(s))


def validate_positive(name: str, value: float) -> None:
    if value <= 0:
        raise ValueError(f"{name} must be positive, got {value}")
