"""Config dict with attribute access, and YAML loading.

The port's own copy of ``self_forcing_tpu/config.py``: a dict read with
attribute syntax plus ``getattr(config, key, default)`` at use sites, and
``load_config``, an experiment YAML merged over the default config
(PyYAML, present on both the CPU and the card's machine).
"""
from __future__ import annotations

import copy
import os
from typing import Any, Mapping

import yaml


class Config(dict):
    """dict with attribute access and recursive wrapping.

    ``cfg.key`` ≡ ``cfg["key"]``; missing attribute raises AttributeError so
    that ``getattr(cfg, k, default)`` behaves like the reference's OmegaConf
    usage.
    """

    def __init__(self, data: Mapping[str, Any] | None = None, **kw: Any):
        super().__init__()
        merged: dict = dict(data or {})
        merged.update(kw)
        for k, v in merged.items():
            self[k] = _wrap(v)

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = _wrap(value)

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __deepcopy__(self, memo):
        return Config({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def to_dict(self) -> dict:
        return {k: (v.to_dict() if isinstance(v, Config) else v) for k, v in self.items()}


def _wrap(value: Any) -> Any:
    if isinstance(value, Config):
        return value
    if isinstance(value, Mapping):
        return Config(value)
    if isinstance(value, (list, tuple)):
        return type(value)(_wrap(v) for v in value)
    return value


def merge(base: Mapping[str, Any], override: Mapping[str, Any]) -> Config:
    """Recursive merge: ``override`` wins, dicts merge key-wise."""
    out = Config(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], Mapping) and isinstance(v, Mapping):
            out[k] = merge(out[k], v)
        else:
            out[k] = _wrap(v)
    return out


def load_yaml(path: str) -> Config:
    with open(path) as f:
        return Config(yaml.safe_load(f) or {})


def load_config(config_path: str, default_path: str | None = None) -> Config:
    """An experiment config merged over the default config (when that
    file exists)."""
    cfg = load_yaml(config_path)
    if default_path is not None and os.path.exists(default_path):
        cfg = merge(load_yaml(default_path), cfg)
    return cfg
