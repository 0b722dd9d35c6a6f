"""Configs: YAML files under `configs/` composed through their `defaults`
lists, with `key.subkey=value` overrides (the port's own copy of
`audiocraft_tpu/config.py`'s loader; it reads the same files)."""
import json
import typing as tp
from pathlib import Path

import yaml

CONFIG_ROOT = Path(__file__).resolve().parents[1] / "configs"


def _deep_update(base: dict, update: dict) -> dict:
    """Merge `update` into `base` in place, recursing where both hold a dict."""
    for key, value in update.items():
        if isinstance(value, dict) and isinstance(base.get(key), dict):
            _deep_update(base[key], value)
        else:
            base[key] = value
    return base


def load_yaml(path: tp.Union[str, Path]) -> dict:
    with open(path) as f:
        return yaml.safe_load(f) or {}


def load_config(name: str, root: tp.Optional[Path] = None) -> dict:
    """`configs/<name>.yaml` with its `defaults` composed first, in order,
    each overridden by the next and all by the file itself (or, with
    `_self_` in the list, by what follows it). A default resolves against the
    file's own directory first, then the configs root."""
    root = Path(root or CONFIG_ROOT).resolve()
    path = (root / f"{name}.yaml").resolve()
    raw = load_yaml(path)
    cfg: dict = {}
    for dep in raw.pop("defaults", []):
        if dep == "_self_":
            _deep_update(cfg, raw)
            raw = {}
            continue
        local = (path.parent / f"{dep}.yaml").resolve()
        dep_name = str(local.relative_to(root))[:-5] if local.exists() else dep
        _deep_update(cfg, load_config(dep_name, root))
    return _deep_update(cfg, raw)


def parse_value(s: str):
    """A JSON value where the string parses as one (numbers, lists, true,
    null), else the string itself."""
    try:
        return json.loads(s)
    except ValueError:
        return s


def apply_overrides(cfg: dict, overrides: tp.Sequence[str]) -> dict:
    """Apply `a.b.c=value` overrides to `cfg` in place; returns the delta."""
    delta: dict = {}
    for override in overrides:
        if "=" not in override:
            raise ValueError(f"override must be key=value, got {override!r}")
        key, value = override.split("=", 1)
        value = parse_value(value)
        *parents, leaf = key.split(".")
        node, dnode = cfg, delta
        for part in parents:
            node = node.setdefault(part, {})
            dnode = dnode.setdefault(part, {})
        node[leaf] = value
        dnode[leaf] = value
    return delta
