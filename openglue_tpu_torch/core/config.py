"""Config system (port of ``openglue_tpu/core/config.py``): nested-dict
configs with attribute access, deep merge and YAML IO, the base YAML and an
override YAML merged as the reference's OmegaConf use does, without
OmegaConf."""

from __future__ import annotations

import copy
from pathlib import Path
from typing import Any, Mapping, Union

import yaml


class Config(dict):
    """A dict with attribute access and recursive wrapping of nested mappings.

    ``cfg.train.lr`` and ``cfg['train']['lr']`` are interchangeable. Missing
    attribute access raises ``AttributeError`` (missing key access raises
    ``KeyError`` as usual). ``get`` supports dotted paths: ``cfg.get('a.b', 3)``.
    """

    def __init__(self, data: Mapping[str, Any] | None = None, **kwargs):
        super().__init__()
        merged = dict(data or {})
        merged.update(kwargs)
        for key, value in merged.items():
            self[key] = value

    @staticmethod
    def _wrap(value: Any) -> Any:
        if isinstance(value, Config):
            return value
        if isinstance(value, Mapping):
            return Config(value)
        if isinstance(value, (list, tuple)):
            return type(value)(Config._wrap(v) for v in value)
        return value

    def __setitem__(self, key: str, value: Any) -> None:
        super().__setitem__(key, self._wrap(value))

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as exc:
            raise AttributeError(name) from exc

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError as exc:
            raise AttributeError(name) from exc

    def get(self, key: str, default: Any = None) -> Any:
        """dict.get with dotted-path support."""
        node: Any = self
        for part in key.split("."):
            if isinstance(node, Mapping) and part in node:
                node = node[part]
            else:
                return default
        return node

    def to_dict(self) -> dict:
        def unwrap(value):
            if isinstance(value, Mapping):
                return {k: unwrap(v) for k, v in value.items()}
            if isinstance(value, (list, tuple)):
                return [unwrap(v) for v in value]
            return value

        return unwrap(self)

    def copy(self) -> "Config":
        return Config(copy.deepcopy(self.to_dict()))

    def to_yaml(self) -> str:
        return yaml.safe_dump(self.to_dict(), sort_keys=False)


def merge_configs(base: Mapping[str, Any], *overrides: Mapping[str, Any]) -> Config:
    """Recursive merge; later configs win; dicts merge, everything else replaces."""

    def merge_into(dst: dict, src: Mapping[str, Any]) -> dict:
        for key, value in src.items():
            if key in dst and isinstance(dst[key], Mapping) and isinstance(value, Mapping):
                dst[key] = merge_into(dict(dst[key]), value)
            else:
                dst[key] = copy.deepcopy(value) if isinstance(value, (Mapping, list)) else value
        return dst

    result: dict = {}
    merge_into(result, base)
    for override in overrides:
        merge_into(result, override)
    return Config(result)


def load_config(path: Union[str, Path]) -> Config:
    with open(path) as f:
        return Config(yaml.safe_load(f) or {})


def save_config(config: Mapping[str, Any], path: Union[str, Path]) -> None:
    cfg = config if isinstance(config, Config) else Config(config)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        f.write(cfg.to_yaml())
