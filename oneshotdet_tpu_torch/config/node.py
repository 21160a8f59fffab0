"""Minimal yacs-compatible configuration node (the port's own copy).

The reference uses yacs (`maskrcnn_benchmark/config/__init__.py`); yacs is not
available in this image, so we implement the subset of its API the framework
needs: attribute access, `merge_from_file` (YAML overlay), `merge_from_list`
(CLI ``KEY VALUE`` pairs), `clone`, `freeze`/`defrost`, and `dump`.

Reference yamls (e.g. ``configs/fcos/2019_10_25_vanilla_siamse_backbone.yaml``)
load unchanged through this class.
"""

from __future__ import annotations

import ast
import copy
from typing import Any

_FROZEN = "__cfg_frozen__"


class CfgNode(dict):
    """A dict with attribute access and yacs-style merge semantics."""

    def __init__(self, init: dict | None = None):
        super().__init__()
        object.__setattr__(self, _FROZEN, False)
        if init:
            for k, v in init.items():
                self[k] = CfgNode(v) if isinstance(v, dict) else v

    # -- attribute access -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, _FROZEN):
            raise AttributeError(
                f"Attempted to set {name} on an immutable (frozen) CfgNode"
            )
        self[name] = value

    def __setitem__(self, key, value):
        if object.__getattribute__(self, _FROZEN):
            raise AttributeError(
                f"Attempted to set {key} on an immutable (frozen) CfgNode"
            )
        super().__setitem__(key, value)

    # -- freezing ----------------------------------------------------------
    def freeze(self) -> None:
        object.__setattr__(self, _FROZEN, True)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.freeze()

    def defrost(self) -> None:
        object.__setattr__(self, _FROZEN, False)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.defrost()

    def is_frozen(self) -> bool:
        return object.__getattribute__(self, _FROZEN)

    # -- merging -----------------------------------------------------------
    def clone(self) -> "CfgNode":
        out = CfgNode()
        for k, v in self.items():
            out[k] = v.clone() if isinstance(v, CfgNode) else copy.deepcopy(v)
        return out

    def merge_from_other_cfg(self, other: dict) -> None:
        self._merge(other, [])

    def _merge(self, other: dict, path: list) -> None:
        for k, v in other.items():
            full = ".".join(path + [str(k)])
            if k not in self:
                raise KeyError(f"Non-existent config key: {full}")
            if isinstance(self[k], CfgNode):
                if not isinstance(v, dict):
                    raise TypeError(f"Cannot overwrite config subtree {full} with a value")
                self[k]._merge(v, path + [str(k)])
            else:
                super().__setitem__(k, _coerce(v, self[k], full))

    def merge_from_file(self, filename: str) -> None:
        import yaml

        with open(filename, "r") as f:
            loaded = yaml.safe_load(f)
        if loaded:
            self.merge_from_other_cfg(loaded)

    def merge_from_list(self, opts: list) -> None:
        assert len(opts) % 2 == 0, f"Override list has odd length: {opts}"
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                if p not in node:
                    raise KeyError(f"Non-existent config key: {key}")
                node = node[p]
            leaf = parts[-1]
            if leaf not in node:
                raise KeyError(f"Non-existent config key: {key}")
            if isinstance(value, str):
                try:
                    value = ast.literal_eval(value)
                except (ValueError, SyntaxError):
                    pass
            dict.__setitem__(node, leaf, _coerce(value, node[leaf], key))

    # -- io ------------------------------------------------------------------
    def dump(self) -> str:
        import yaml

        def to_plain(node):
            return {
                k: to_plain(v) if isinstance(v, CfgNode) else v
                for k, v in node.items()
            }

        return yaml.safe_dump(to_plain(self), default_flow_style=None)

    def __str__(self) -> str:
        return self.dump()


def _coerce(value: Any, old: Any, key: str) -> Any:
    """Coerce a replacement value to the type of the default (yacs semantics)."""
    if old is None or value is None:
        return value
    # yacs evaluates python-literal strings from YAML, e.g. "(0.125, 0.0625)".
    if isinstance(value, str) and not isinstance(old, str):
        try:
            value = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            pass
    if isinstance(old, tuple) and isinstance(value, (list, tuple)):
        return tuple(value)
    if isinstance(old, list) and isinstance(value, (list, tuple)):
        return list(value)
    if type(value) is type(old):
        return value
    # int -> float promotion and bool/int strictness, mirroring yacs.
    if isinstance(old, float) and isinstance(value, int):
        return float(value)
    if isinstance(old, bool) != isinstance(value, bool):
        raise TypeError(f"Type mismatch for key {key}: {type(value)} vs {type(old)}")
    if isinstance(old, (int, float)) and isinstance(value, (int, float)):
        return type(old)(value)
    raise TypeError(f"Type mismatch for key {key}: {type(value)} vs {type(old)}")
