"""Config system: YAML with recursive `base_config` composition and
attribute access.

Behavioral reference: src/util/config_util.py:35-71 — a config file lists
`base_config: [paths...]`; bases are loaded first (depth-first), later
files override earlier ones key-by-key (recursive dict merge); the top
file wins last. `find_value_in_omegaconf` becomes `find_value`.

Implementation is OmegaConf-free: a thin dot-access wrapper over plain
dicts, YAML via pyyaml. A copy of the framework-free
`marigold_tpu/config.py` for the PyTorch port; pyyaml is imported only
where a file is read, so building a Config in code needs no yaml.
"""

from __future__ import annotations

import os
from typing import Any, Iterator, Mapping


class Config(dict):
    """dict with attribute access and recursive wrapping."""

    def __getattr__(self, name: str) -> Any:
        try:
            v = self[name]
        except KeyError as e:
            raise AttributeError(name) from e
        return _wrap(v)

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def get(self, key, default=None):
        v = super().get(key, default)
        return _wrap(v)

    def to_dict(self) -> dict:
        return _unwrap(self)


def _wrap(v):
    if isinstance(v, Config):
        return v
    if isinstance(v, Mapping):
        return Config(v)
    if isinstance(v, list):
        return [_wrap(x) for x in v]
    return v


def _unwrap(v):
    if isinstance(v, Mapping):
        return {k: _unwrap(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_unwrap(x) for x in v]
    return v


def merge_configs(base: Mapping, override: Mapping) -> Config:
    """Recursive merge; `override` wins (reference config_util.py:46-52)."""
    out = dict(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], Mapping) and isinstance(v, Mapping):
            out[k] = merge_configs(out[k], v)
        else:
            out[k] = v
    return Config(out)


def load_yaml(path: str) -> Config:
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f) or {}
    return Config(data)


def recursive_load_config(path: str) -> Config:
    """Load `path`, composing its `base_config` list depth-first; the
    current file's own values override all bases; later bases override
    earlier ones (reference recursive_load_config, config_util.py:35-54)."""
    conf = load_yaml(path)
    base_paths = conf.pop("base_config", None) or []
    out: Config = Config({})
    for base_path in base_paths:
        if not os.path.isabs(base_path):
            # bases are repo-root-relative (reference convention)
            candidates = [
                base_path,
                os.path.join(os.path.dirname(path), base_path),
            ]
            base_path = next(
                (c for c in candidates if os.path.exists(c)), base_path
            )
        base = recursive_load_config(base_path)
        out = merge_configs(out, base)
    out = merge_configs(out, conf)
    return out


def find_value(cfg: Mapping, key: str) -> Iterator[Any]:
    """Yield every value stored under `key` anywhere in the tree
    (reference find_value_in_omegaconf, config_util.py:57-71)."""
    for k, v in cfg.items():
        if k == key:
            yield v
        if isinstance(v, Mapping):
            yield from find_value(v, key)
        elif isinstance(v, list):
            for item in v:
                if isinstance(item, Mapping):
                    yield from find_value(item, key)
