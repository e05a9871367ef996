"""String-keyed registries for models and datasets (a copy of
``act_tpu/utils/registry.py``).

Mirrors the public behavior of the reference's mmcv-style registry
(``utils/registry.py:6`` and ``build_from_cfg`` at ``utils/registry.py:246-288`` in
RunpeiDong/ACT): classes register under their name, and ``build_from_cfg`` instantiates
from an ``EasyDict``-like config keyed on ``NAME``, merging optional ``default_args``.
"""
from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, Optional


class Registry:
    """A name -> class registry.

    Example::

        MODELS = Registry('model')

        @MODELS.register_module()
        class PointTransformer(nn.Module):
            ...

        model = MODELS.build(cfg)   # cfg.NAME == 'PointTransformer'
    """

    def __init__(self, name: str):
        self._name = name
        self._module_dict: Dict[str, Any] = {}

    def __repr__(self):
        return f"Registry(name={self._name}, items={list(self._module_dict)})"

    def __contains__(self, key: str) -> bool:
        return key in self._module_dict

    def __len__(self) -> int:
        return len(self._module_dict)

    @property
    def name(self) -> str:
        return self._name

    @property
    def module_dict(self) -> Dict[str, Any]:
        return self._module_dict

    def get(self, key: str) -> Optional[Any]:
        return self._module_dict.get(key)

    def register_module(self, name: Optional[str] = None, module: Optional[Any] = None,
                        force: bool = False) -> Callable:
        """Register a class, usable as a decorator or a direct call."""
        if module is not None:
            self._register(module, name=name, force=force)
            return module

        def _decorator(cls):
            self._register(cls, name=name, force=force)
            return cls

        return _decorator

    def _register(self, module: Any, name: Optional[str] = None, force: bool = False):
        if not (inspect.isclass(module) or inspect.isfunction(module)):
            raise TypeError(f"module must be a class or function, got {type(module)}")
        key = name if name is not None else module.__name__
        if not force and key in self._module_dict:
            raise KeyError(f"{key} is already registered in {self._name}")
        self._module_dict[key] = module

    def build(self, cfg, **default_args) -> Any:
        return build_from_cfg(cfg, self, default_args or None)


def build_from_cfg(cfg, registry: Registry, default_args: Optional[dict] = None) -> Any:
    """Instantiate ``registry[cfg.NAME](cfg, **extra)``.

    Matches the reference convention: the whole (merged) config node is passed as the
    first positional ``config`` argument; any keys in ``default_args`` are merged into
    the config node first (reference ``utils/registry.py:270-279``).
    """
    if cfg is None or "NAME" not in cfg:
        raise KeyError(f"cfg must contain the key 'NAME', got {cfg!r}")
    if default_args:
        for k, v in default_args.items():
            cfg.setdefault(k, v)
    name = cfg["NAME"]
    obj_cls = registry.get(name)
    if obj_cls is None:
        raise KeyError(f"{name} is not in the {registry.name} registry "
                       f"(known: {sorted(registry.module_dict)})")
    return obj_cls(cfg)
