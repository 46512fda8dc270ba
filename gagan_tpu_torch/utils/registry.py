"""Name -> class registry with config-dataclass generation (a
framework-free copy of gagan_tpu/utils/registry.py): each registered
callable gets a plain dataclass whose fields mirror its signature."""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, List, Optional, Union


def make_dataclass_from_func(func, name: str, arg_keys=None):
    """Dataclass whose fields mirror ``func``'s signature; required params
    become Optional[Any] = None fields."""
    sig = inspect.signature(func).parameters
    fields = []
    for k, v in sig.items():
        if k in ("self", "args", "kwargs"):
            continue
        if v.default is inspect.Parameter.empty or v.default is None:
            fields.append((k, Optional[Any], dataclasses.field(default=None)))
        else:
            fields.append((k, type(v.default),
                           dataclasses.field(default=v.default)))
    if arg_keys:
        groups = {key: dataclasses.make_dataclass(key, fields)
                  for key in arg_keys}
        return dataclasses.make_dataclass(
            name, [(k, v, dataclasses.field(default_factory=v))
                   for k, v in groups.items()])
    return dataclasses.make_dataclass(name, fields)


class ClassRegistry:
    def __init__(self):
        self.classes = {}
        self.args = {}
        self.arg_keys = None

    def __getitem__(self, item):
        return self.classes[item]

    def __contains__(self, name: str) -> bool:
        return name in self.args

    def __repr__(self) -> str:
        return f"{list(self.args.keys())}"

    def add_to_registry(self, names: Union[str, List[str]], arg_keys=None):
        if not isinstance(names, list):
            names = [names]

        def decorator(obj):
            for name in names:
                self.classes[name] = obj
                target = obj.__init__ if inspect.isclass(obj) else obj
                if arg_keys:
                    self.arg_keys = arg_keys
                self.args[name] = make_dataclass_from_func(
                    target, name, arg_keys)
            return obj

        return decorator

    def make_dataclass_from_classes(self, name: str = "Name"):
        return dataclasses.make_dataclass(
            name, [(k, v, dataclasses.field(default_factory=v))
                   for k, v in self.classes.items()])

    def make_dataclass_from_args(self, name: str = "Name"):
        return dataclasses.make_dataclass(
            name, [(k, v, dataclasses.field(default_factory=v))
                   for k, v in self.args.items()])
