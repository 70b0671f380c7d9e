"""Registry + build_from_cfg (own copy of lidarseg3d_tpu/utils/registry.py).

Keeps the dict-driven module instantiation surface, so the JAX package's
config dicts build the port's ``nn.Module``s unchanged.
"""

import inspect
from collections.abc import Mapping


class Registry:
    def __init__(self, name):
        self._name = name
        self._module_dict = {}

    def __repr__(self):
        return (f"{self.__class__.__name__}(name={self._name}, "
                f"items={list(self._module_dict)})")

    @property
    def name(self):
        return self._name

    @property
    def module_dict(self):
        return self._module_dict

    def get(self, key):
        return self._module_dict.get(key, None)

    def register_module(self, cls=None, *, name=None):
        # usable as @REG.register_module or @REG.register_module(name="X")
        if cls is None:
            return lambda c: self.register_module(c, name=name)
        if not inspect.isclass(cls) and not inspect.isfunction(cls):
            raise TypeError(
                f"module must be a class or function, got {type(cls)}")
        key = name or cls.__name__
        if key in self._module_dict:
            raise KeyError(f"{key} already registered in {self._name}")
        self._module_dict[key] = cls
        return cls


def build_from_cfg(cfg, registry, default_args=None):
    """Instantiate an object from a ``dict(type=..., **kwargs)`` config."""
    if not isinstance(cfg, Mapping) or "type" not in cfg:
        raise TypeError(f"cfg must be a dict with a 'type' key, got {cfg!r}")
    args = dict(cfg)
    obj_type = args.pop("type")
    if isinstance(obj_type, str):
        obj_cls = registry.get(obj_type)
        if obj_cls is None:
            raise KeyError(
                f"{obj_type} is not in the {registry.name} registry")
    elif inspect.isclass(obj_type):
        obj_cls = obj_type
    else:
        raise TypeError(f"type must be a str or class, got {type(obj_type)}")
    if default_args is not None:
        for k, v in default_args.items():
            args.setdefault(k, v)
    return obj_cls(**args)
