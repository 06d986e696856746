"""Hyper-parameter namespace (the port's own copy of ``Recursive_Parse``).

Compact checkpoints carry their hparams in ``meta["hp"]``, so the serving
path never reads YAML; ``yaml`` is imported only by
:func:`load_hyper_parameters`, inside the function.
"""

from __future__ import annotations

import copy
import pathlib
from typing import Any, Mapping


class HParams:
    """Recursive attribute-access namespace over a nested dict.

    ``hp.Sound.Mel_Dim`` and ``hp["Sound"]["Mel_Dim"]`` both work; unknown
    attributes raise ``AttributeError`` naming the full dotted path.
    """

    def __init__(self, data: Mapping[str, Any], _path: str = ""):
        object.__setattr__(self, "_path", _path)
        object.__setattr__(self, "_data", {})
        for key, value in data.items():
            self._data[key] = self._wrap(key, value)

    def _wrap(self, key: str, value: Any) -> Any:
        child_path = f"{self._path}.{key}" if self._path else key
        if isinstance(value, Mapping):
            return HParams(value, child_path)
        if isinstance(value, list):
            return [
                HParams(v, f"{child_path}[{i}]") if isinstance(v, Mapping) else v
                for i, v in enumerate(value)
            ]
        return value

    def __getattr__(self, name: str) -> Any:
        data = object.__getattribute__(self, "_data")
        if name in data:
            return data[name]
        path = object.__getattribute__(self, "_path")
        full = f"{path}.{name}" if path else name
        raise AttributeError(f"No hyper-parameter '{full}'")

    def __setattr__(self, name: str, value: Any) -> None:
        self._data[name] = self._wrap(name, value)

    def __getitem__(self, key: str) -> Any:
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def get(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, default)

    def keys(self):
        return self._data.keys()

    def items(self):
        return self._data.items()

    def to_dict(self) -> dict:
        out = {}
        for key, value in self._data.items():
            if isinstance(value, HParams):
                out[key] = value.to_dict()
            elif isinstance(value, list):
                out[key] = [
                    v.to_dict() if isinstance(v, HParams) else v for v in value
                ]
            else:
                out[key] = value
        return out

    def replace(self, **overrides: Any) -> "HParams":
        """Deep copy with top-level keys replaced (nested dicts merge)."""
        data = copy.deepcopy(self.to_dict())
        for key, value in overrides.items():
            if (
                key in data
                and isinstance(data[key], dict)
                and isinstance(value, Mapping)
            ):
                data[key] = _deep_merge(data[key], value)
            else:
                data[key] = value
        return HParams(data)

    def __repr__(self) -> str:
        return f"HParams({self.to_dict()!r})"

    def __eq__(self, other: object) -> bool:
        if isinstance(other, HParams):
            return self.to_dict() == other.to_dict()
        return NotImplemented


def _deep_merge(base: dict, override: Mapping) -> dict:
    out = dict(base)
    for key, value in override.items():
        if key in out and isinstance(out[key], dict) and isinstance(value, Mapping):
            out[key] = _deep_merge(out[key], value)
        else:
            out[key] = copy.deepcopy(value) if isinstance(value, (dict, list)) else value
    return out


def Recursive_Parse(data: Mapping[str, Any]) -> HParams:
    """Reference-compatible entry point: dict -> namespace."""
    return HParams(data)


def load_hyper_parameters(path: str | pathlib.Path) -> HParams:
    """Read a reference-format Hyper_Parameters.yaml (needs ``pyyaml``)."""
    import yaml

    with open(path, "r", encoding="utf-8") as f:
        return Recursive_Parse(yaml.safe_load(f))
