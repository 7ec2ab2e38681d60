"""Config dict with attribute access.

The port's own copy of the ``Config`` of ``self_forcing_tpu/config.py``:
a dict read with attribute syntax plus ``getattr(config, key, default)``
at use sites (the pipeline's ``args``).  YAML loading and merging come
with the port's entry points.
"""
from __future__ import annotations

import copy
from typing import Any, Mapping


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
