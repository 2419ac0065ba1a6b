"""YAML experiment-config system with interpolation and CLI dotlist overrides.

The PyTorch port's own copy of ``instant_nsr_pl_tpu/config.py`` (the port
imports nothing of the JAX package). It replaces the reference's OmegaConf
usage (reference: utils/misc.py:7-40) with the subset the framework needs:

- YAML loading with nested attribute access (``cfg.model.geometry.radius``)
- ``${a.b.c}`` value interpolation (absolute paths from the root)
- custom resolvers ``${name:arg1,arg2}``: calc_exp_lr_decay_rate, add, sub,
  mul, div, idiv, basename (reference: utils/misc.py:7-13)
- ``???`` mandatory-value markers (error when accessed unresolved)
- CLI dotlist merges: ``model.radius=2.0 system.loss.lambda_rgb=5``
"""

from __future__ import annotations

import copy
import os
import re
from typing import Any

import yaml

_INTERP_RE = re.compile(r"\$\{([^${}]+)\}")

MISSING = "???"


def _resolver_calc_exp_lr_decay_rate(factor, n):
    # gamma such that gamma**n == factor (reference: utils/misc.py:7)
    return float(factor) ** (1.0 / float(n))


_RESOLVERS = {
    "calc_exp_lr_decay_rate": _resolver_calc_exp_lr_decay_rate,
    "add": lambda a, b: float(a) + float(b),
    "sub": lambda a, b: float(a) - float(b),
    "mul": lambda a, b: float(a) * float(b),
    "div": lambda a, b: float(a) / float(b),
    "idiv": lambda a, b: int(float(a) // float(b)),
    "basename": lambda p: os.path.basename(str(p)),
}


def register_resolver(name, fn):
    _RESOLVERS[name] = fn


class ConfigNode:
    """A dict with attribute access. Leaves are plain Python values."""

    def __init__(self, data: dict | None = None):
        object.__setattr__(self, "_data", {})
        if data:
            for k, v in data.items():
                self._data[k] = _wrap(v)

    # -- mapping protocol -------------------------------------------------
    def __getitem__(self, key):
        v = self._data[key]
        if v == MISSING:
            raise ValueError(f"Mandatory config value '{key}' is missing (???)")
        return v

    def __setitem__(self, key, value):
        self._data[key] = _wrap(value)

    def __getattr__(self, key):
        if key.startswith("_"):
            raise AttributeError(key)
        try:
            return self[key]
        except KeyError:
            raise AttributeError(f"Config has no key '{key}'")

    def __setattr__(self, key, value):
        if key.startswith("_"):
            object.__setattr__(self, key, value)
        else:
            self[key] = value

    def __contains__(self, key):
        return key in self._data

    def __iter__(self):
        return iter(self._data)

    def __len__(self):
        return len(self._data)

    def __eq__(self, other):
        if isinstance(other, ConfigNode):
            return self._data == other._data
        if isinstance(other, dict):
            return self.to_dict() == other
        return NotImplemented

    def __repr__(self):
        return f"ConfigNode({self._data!r})"

    def get(self, key, default=None):
        v = self._data.get(key, default)
        if v == MISSING:
            return default
        return v

    def keys(self):
        return self._data.keys()

    def values(self):
        return self._data.values()

    def items(self):
        return self._data.items()

    def setdefault(self, key, default=None):
        if key not in self._data:
            self[key] = default
        return self[key]

    def to_dict(self) -> dict:
        return _unwrap(self)


def _wrap(v):
    if isinstance(v, ConfigNode):
        return v
    if isinstance(v, dict):
        return ConfigNode(v)
    if isinstance(v, (list, tuple)):
        return [_wrap(x) for x in v]
    return v


def _unwrap(v):
    if isinstance(v, ConfigNode):
        return {k: _unwrap(x) for k, x in v._data.items()}
    if isinstance(v, list):
        return [_unwrap(x) for x in v]
    return v


def _get_path(root: ConfigNode, path: str):
    cur: Any = root
    for part in path.split("."):
        if isinstance(cur, ConfigNode):
            cur = cur._data[part]
        elif isinstance(cur, list):
            cur = cur[int(part)]
        else:
            raise KeyError(path)
    return cur


def _set_path(root: ConfigNode, path: str, value):
    parts = path.split(".")
    cur: Any = root
    for part in parts[:-1]:
        if isinstance(cur, ConfigNode):
            if part not in cur._data or not isinstance(
                cur._data[part], (ConfigNode, list)
            ):
                cur._data[part] = ConfigNode()
            cur = cur._data[part]
        elif isinstance(cur, list):
            cur = cur[int(part)]
    last = parts[-1]
    if isinstance(cur, list):
        cur[int(last)] = _wrap(value)
    else:
        cur._data[last] = _wrap(value)


def _parse_scalar(s: str):
    try:
        return yaml.safe_load(s)
    except yaml.YAMLError:
        return s


def _resolve_value(v, root, depth=0):
    if depth > 32:
        raise RecursionError("config interpolation too deep (cycle?)")
    if not isinstance(v, str):
        return v
    for _ in range(32):
        # a string that is exactly one ${...} may resolve to a non-string
        m = _INTERP_RE.fullmatch(v.strip())
        if m:
            r = _resolve_expr(m.group(1), root, depth)
            if isinstance(r, str) and _INTERP_RE.search(r):
                v = r
                continue
            return r
        if not _INTERP_RE.search(v):
            return v
        # substitute innermost ${...} occurrences, then re-examine
        v = _INTERP_RE.sub(
            lambda mm: str(_resolve_expr(mm.group(1), root, depth)), v
        )
    raise RecursionError("config interpolation too deep (cycle?)")


def _resolve_expr(expr: str, root, depth):
    expr = expr.strip()
    if ":" in expr:
        name, _, argstr = expr.partition(":")
        name = name.strip()
        if name in _RESOLVERS:
            args = [
                _resolve_value(a.strip(), root, depth + 1)
                for a in argstr.split(",")
            ]
            args = [_parse_scalar(a) if isinstance(a, str) else a for a in args]
            return _RESOLVERS[name](*args)
    # plain path interpolation
    target = _get_path(root, expr)
    return _resolve_value(target, root, depth + 1)


def _resolve_tree(node, root):
    if isinstance(node, ConfigNode):
        for k in list(node._data.keys()):
            node._data[k] = _resolve_tree(node._data[k], root)
        return node
    if isinstance(node, list):
        return [_resolve_tree(x, root) for x in node]
    return _resolve_value(node, root)


def merge_dotlist(cfg: ConfigNode, dotlist: list[str]) -> ConfigNode:
    for item in dotlist:
        if "=" not in item:
            raise ValueError(f"Override '{item}' is not of the form key=value")
        key, _, value = item.partition("=")
        _set_path(cfg, key.strip(), _parse_scalar(value.strip()))
    return cfg


def load_config(path: str, cli_args: list[str] | None = None, resolve=True) -> ConfigNode:
    """Load a YAML config, merge CLI dotlist overrides, resolve interpolations.

    Mirrors the reference's ``load_config`` (utils/misc.py:26-31).
    """
    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    cfg = ConfigNode(raw)
    if cli_args:
        merge_dotlist(cfg, cli_args)
    if resolve:
        _resolve_tree(cfg, cfg)
    return cfg


def config_from_dict(d: dict, resolve=True) -> ConfigNode:
    cfg = ConfigNode(copy.deepcopy(d))
    if resolve:
        _resolve_tree(cfg, cfg)
    return cfg


def config_to_primitive(cfg) -> Any:
    if isinstance(cfg, ConfigNode):
        return cfg.to_dict()
    if isinstance(cfg, list):
        return [config_to_primitive(x) for x in cfg]
    return cfg


def dump_config(path: str, cfg: ConfigNode):
    with open(path, "w") as f:
        yaml.safe_dump(cfg.to_dict(), f, sort_keys=False)
