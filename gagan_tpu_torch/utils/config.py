"""Config (de)serialization for the port's config dataclasses (port of
gagan_tpu/utils/config.py).  The field names are the JAX package's, so a
``g_cfg`` or ``d_cfg`` dict written by either package builds either
config."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Type, TypeVar

from ..models import stylegan2 as sg2

T = TypeVar("T")


def to_dict(cfg: Any) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


def from_dict(cls: Type[T], data: Dict[str, Any]) -> T:
    """Reconstruct a (possibly nested) dataclass from a plain dict; keys that
    are not fields of ``cls`` are ignored, lists become tuples."""
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        value = data[f.name]
        if dataclasses.is_dataclass(f.type) and isinstance(value, dict):
            kwargs[f.name] = from_dict(f.type, value)
        elif isinstance(value, list):
            kwargs[f.name] = tuple(value)
        else:
            kwargs[f.name] = value
    return cls(**kwargs)


_FIELD_TYPES = {
    "mapping": sg2.MappingConfig,
    "synthesis": sg2.SynthesisConfig,
}


def generator_config_from_dict(data: Dict[str, Any]) -> sg2.GeneratorConfig:
    kwargs = dict(data)
    for key, sub_cls in _FIELD_TYPES.items():
        if key in kwargs and isinstance(kwargs[key], dict):
            kwargs[key] = from_dict(sub_cls, kwargs[key])
    fields = {f.name for f in dataclasses.fields(sg2.GeneratorConfig)}
    return sg2.GeneratorConfig(**{k: v for k, v in kwargs.items()
                                  if k in fields})


def discriminator_config_from_dict(
        data: Dict[str, Any]) -> sg2.DiscriminatorConfig:
    kwargs = dict(data)
    if "mapping" in kwargs and isinstance(kwargs["mapping"], dict):
        kwargs["mapping"] = from_dict(sg2.MappingConfig, kwargs["mapping"])
    if "resample_filter" in kwargs:
        kwargs["resample_filter"] = tuple(kwargs["resample_filter"])
    fields = {f.name for f in dataclasses.fields(sg2.DiscriminatorConfig)}
    return sg2.DiscriminatorConfig(**{k: v for k, v in kwargs.items()
                                      if k in fields})


def apply_dotlist(data: Dict[str, Any], overrides) -> Dict[str, Any]:
    """Apply ``key.path=value`` overrides to a nested dict in place (values
    parsed as Python literals where they parse, else kept as strings)."""
    import ast

    for item in overrides:
        key, _, raw = item.partition("=")
        try:
            value = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            value = raw
        node = data
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return data
