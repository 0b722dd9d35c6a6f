"""Configs: YAML files under `configs/` composed through their `defaults`
lists, with `key.subkey=value` overrides, and experiments named by the
signature of their overrides (the port's own copy of
`audiocraft_tpu/config.py`; it reads the same files)."""
import hashlib
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


# keys that leave the experiment the same (devices, loggers, workers)
EXCLUDE_FROM_SIG = ("device", "wandb", "tensorboard", "logging", "slurm",
                    "dora", "num_workers")


def signature(delta: dict, length: int = 8) -> str:
    """The experiment's signature: the SHA-1 of its override delta (top-level
    keys of `EXCLUDE_FROM_SIG` left out) as sorted compact JSON, cut to
    `length` hex digits; the same delta has the JAX package's signature."""
    kept = {k: v for k, v in delta.items() if k not in EXCLUDE_FROM_SIG}
    blob = json.dumps(kept, sort_keys=True, separators=(",", ":"))
    return hashlib.sha1(blob.encode()).hexdigest()[:length]


class XP:
    """An experiment: its composed config, the override delta, the
    signature of the delta and its folder `<dora dir>/xps/<sig>`."""

    def __init__(self, cfg: dict, delta: dict,
                 root: tp.Optional[Path] = None):
        from .environment import AudioCraftEnvironment
        self.cfg = cfg
        self.delta = delta
        self.sig = signature(delta)
        self.folder = (Path(root or AudioCraftEnvironment.get_dora_dir())
                       / "xps" / self.sig)

    @classmethod
    def from_solver(cls, solver_name: str, overrides: tp.Sequence[str] = ()):
        cfg = load_config(f"solver/{solver_name}")
        delta = apply_overrides(cfg, overrides)
        delta["solver"] = solver_name
        return cls(cfg, delta)
