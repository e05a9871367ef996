"""YAML config system with ``_base_`` includes and attribute access.

A copy of the YAML part of ``act_tpu/utils/config.py`` (reference
``utils/config.py:18-63``): ``cfg_from_yaml_file`` resolves recursive
``_base_`` includes (paths relative to the working directory, which is the
repository root for the shipped configs), merges leaf-over-base, and returns
an attribute-accessible dict. The same YAML files drive both packages.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Any

import yaml


class ConfigDict(dict):
    """A dict with attribute access (stand-in for easydict.EasyDict)."""

    def __init__(self, d=None, **kwargs):
        super().__init__()
        d = {} if d is None else dict(d)
        d.update(kwargs)
        for k, v in d.items():
            self[k] = _wrap(v)

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any):
        self[name] = _wrap(value)

    def __setitem__(self, name, value):
        super().__setitem__(name, _wrap(value))

    def __delattr__(self, name: str):
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def copy(self) -> "ConfigDict":
        return ConfigDict({k: v for k, v in self.items()})


def _wrap(v: Any) -> Any:
    if isinstance(v, Mapping) and not isinstance(v, ConfigDict):
        return ConfigDict({k: x for k, x in v.items()})
    if isinstance(v, (list, tuple)):
        return type(v)(_wrap(x) for x in v)
    return v


def as_cfg(d) -> "ConfigDict":
    """Coerce any Mapping into an attribute-accessible ConfigDict."""
    if isinstance(d, ConfigDict):
        return d
    return ConfigDict({k: v for k, v in d.items()})


def merge_new_config(config: ConfigDict, new_config: dict) -> ConfigDict:
    """Merge ``new_config`` into ``config``; resolves ``_base_`` includes first.

    Mirrors reference ``utils/config.py:18-35``: a ``_base_`` key is replaced by the
    loaded base file's contents, then sibling keys override recursively.
    """
    for key, val in new_config.items():
        if key == "_base_":
            with open(val) as f:
                base = yaml.safe_load(f)
            config[key] = ConfigDict()
            merge_new_config(config[key], base)
            continue
        if isinstance(val, dict):
            if key not in config or not isinstance(config.get(key), dict):
                config[key] = ConfigDict()
            merge_new_config(config[key], val)
        else:
            config[key] = val
    return config


def cfg_from_yaml_file(cfg_file: str) -> ConfigDict:
    config = ConfigDict()
    with open(cfg_file) as f:
        new_config = yaml.safe_load(f)
    merge_new_config(config=config, new_config=new_config)
    return config
