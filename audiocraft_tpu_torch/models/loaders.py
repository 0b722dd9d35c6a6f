"""Checkpoint loading from local paths (counterpart of
`audiocraft_tpu/models/loaders.py`).

Nothing is downloaded: a name is a path, or a path under
`AUDIOCRAFT_CACHE_DIR`. The files are audiocraft's export packages, which
the JAX package reads too: `*.th`, `state_dict.bin` (the LM) and
`compression_state_dict.bin` (the codec), each a torch pickle holding
`best_state` (the state dict) and `xp.cfg` (the solver config, a dict or
its YAML text). The port's modules keep upstream's names and state-dict
keys, so a package loads without conversion, strictly: a missing or
unexpected key raises.

Not ported: the Hugging Face EnCodec snapshot format (`config.json` +
`model.safetensors`; ROADMAP).
"""
import os
import re
import typing as tp
from pathlib import Path

import torch
import yaml

from ..modules.conditioners import ChromaStemConditioner
from . import builders
from .encodec import CompressionModel
from .lm import LMModel


def get_audiocraft_cache_dir() -> tp.Optional[str]:
    return os.environ.get("AUDIOCRAFT_CACHE_DIR", None)


def _resolve(name: str) -> Path:
    """`name` as a local path, else under `AUDIOCRAFT_CACHE_DIR`."""
    cache = get_audiocraft_cache_dir()
    path = Path(name)
    if path.exists():
        return path
    if cache is not None and (Path(cache) / name).exists():
        return Path(cache) / name
    raise FileNotFoundError(
        f"Checkpoint {name!r} not found locally. This environment has no "
        f"network egress; place an exported checkpoint or HF snapshot under "
        f"AUDIOCRAFT_CACHE_DIR and retry.")


def _package_file(path: Path, patterns: tp.Sequence[str]) -> Path:
    """A file is itself; in a directory, the first match of `patterns`."""
    if not path.is_dir():
        return path
    for pattern in patterns:
        found = sorted(path.glob(pattern))
        if found:
            return found[0]
    raise FileNotFoundError(f"no checkpoint matching {list(patterns)} in "
                            f"{path}")


_INTERPOLATION = re.compile(r"^\$\{([\w.]+)\}$")


def _resolve_interpolations(cfg: dict) -> dict:
    """Replace each value of the form `${a.b}` (OmegaConf's reference, left
    as text in an exported YAML) by the value at that path of `cfg`."""
    def lookup(path: str):
        node: tp.Any = cfg
        for key in path.split("."):
            node = node[key]
        return resolve(node)

    def resolve(node):
        if isinstance(node, dict):
            return {k: resolve(v) for k, v in node.items()}
        if isinstance(node, list):
            return [resolve(v) for v in node]
        match = _INTERPOLATION.match(node) if isinstance(node, str) else None
        return lookup(match.group(1)) if match else node

    return resolve(cfg)


def load_package(path: Path) -> tp.Tuple[tp.Dict[str, torch.Tensor], dict]:
    """An export package's (state dict, config). Read with
    `weights_only=True`: a package whose config is a pickled object rather
    than a dict or YAML text is refused, not executed."""
    pkg = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("best_state", "state_dict"):
        if key in pkg:
            state, cfg = pkg[key], pkg.get("xp.cfg", {})
            break
    else:
        state, cfg = pkg, {}
    if isinstance(cfg, str):
        cfg = yaml.safe_load(cfg) or {}
    return dict(state), _resolve_interpolations(dict(cfg))


def load_compression_model(name: str, device=None) -> CompressionModel:
    """The codec of an export package at `name`
    (`compression_state_dict.bin` or `*.th`). The config's `seanet`, `rvq`,
    `sample_rate` and `channels` may sit at its top level (audiocraft's
    exports) or under `encodec`; convolutions are weight-normed unless it
    says otherwise."""
    path = _resolve(name)
    if path.is_dir() and (path / "config.json").exists():
        raise NotImplementedError(
            f"{path} is a Hugging Face EnCodec snapshot (config.json + "
            f"safetensors), which the port does not read yet (ROADMAP)")
    state, cfg = load_package(_package_file(
        path, ("*.th", "compression_state_dict.bin")))
    enc = dict(cfg.get("encodec", {}) or {})
    for key in ("seanet", "rvq", "sample_rate", "channels"):
        if key not in enc and key in cfg:
            enc[key] = cfg[key]
    enc.setdefault("sample_rate", 32000)
    enc.setdefault("channels", 1)
    enc["seanet"] = {"norm": "weight_norm", **dict(enc.get("seanet", {}))}
    model = builders.get_compression_model(
        {"compression_model": cfg.get("compression_model", "encodec"),
         "encodec": enc}, device=device)
    model.load_state_dict(state, strict=True)
    return model


def load_lm_model(name: str, device=None) -> tp.Tuple[LMModel, dict]:
    """(LM, config) of an export package at `name` (`state_dict.bin` or
    `*.th`), built by `builders.get_lm_model` from the config: MusicGen,
    MusicGen-melody (its chroma conditioner's `output_proj`),
    MusicGen-Style (its MERT is found at tokenize time, see
    `modules.mert.get_mert`), AudioGen or MAGNeT."""
    state, cfg = load_package(_package_file(
        _resolve(name), ("state_dict.bin", "*.th")))
    return _load_lm(state, cfg, device), cfg


def load_lm_model_magnet(name: str, compression_model_frame_rate: int = 50,
                         device=None) -> tp.Tuple[LMModel, dict]:
    """(MAGNeT LM, config) of an export package, with MAGNeT's config
    fixups before the build: `transformer_lm` takes the codec's frame rate
    and the dataset's segment duration, and `masking.span_len` is 3 when
    the config has none."""
    state, cfg = load_package(_package_file(
        _resolve(name), ("state_dict.bin", "*.th")))
    cfg["masking"] = {"span_len": 3, **(cfg.get("masking") or {})}
    cfg["compression_model_framerate"] = compression_model_frame_rate
    cfg["transformer_lm"] = {
        **cfg["transformer_lm"],
        "compression_model_framerate": compression_model_frame_rate,
        "segment_duration": cfg["dataset"]["segment_duration"]}
    return _load_lm(state, cfg, device), cfg


def _load_lm(state: dict, cfg: dict, device) -> LMModel:
    model = builders.get_lm_model(cfg, device=device)
    # a melody conditioner's chroma filter bank and window are computed,
    # not loaded: drop them where an export carries them
    for cond_name, cond in model.condition_provider.conditioners.items():
        if isinstance(cond, ChromaStemConditioner):
            prefix = f"condition_provider.conditioners.{cond_name}.chroma."
            state = {k: v for k, v in state.items()
                     if not k.startswith(prefix)}
    model.load_state_dict(state, strict=True)
    return model
