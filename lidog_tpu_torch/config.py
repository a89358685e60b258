"""YAML config tree, attribute-compatible with the reference YAMLs.

A copy of lidog_tpu/config.py (the port imports nothing of the JAX
package): `get_config(path)` turns a YAML file into a tree of Configs
whose keys are attributes; lists of dicts become lists of Configs.  The
YAMLs under configs/ load unchanged.
"""

from __future__ import annotations

from typing import Any, Dict


class Config:
    def __init__(self, d: Dict[str, Any]):
        self._raw = d
        for k, v in d.items():
            if isinstance(v, dict):
                v = Config(v)
            elif isinstance(v, list):
                v = [Config(x) if isinstance(x, dict) else x for x in v]
            setattr(self, k, v)

    def get(self, key: str, default=None):
        return getattr(self, key, default)

    def to_dict(self) -> Dict[str, Any]:
        return self._raw

    def __repr__(self) -> str:
        return f"Config({self._raw!r})"


def get_config(path: str) -> Config:
    import yaml  # PyYAML, needed only to read a config file

    with open(path) as f:
        return Config(yaml.safe_load(f))
