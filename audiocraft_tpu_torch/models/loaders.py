"""Checkpoint loading from local paths (counterpart of
`audiocraft_tpu/models/loaders.py`).

Nothing is downloaded: a name is a path, or a path under
`AUDIOCRAFT_CACHE_DIR`. The files are audiocraft's export packages, which
the JAX package reads too: `*.th`, `state_dict.bin` (the LM) and
`compression_state_dict.bin` (the codec), each a torch pickle holding
`best_state` (the state dict) and `xp.cfg` (the solver config, a dict or
its YAML text). The port's modules keep upstream's names and state-dict
keys, so a package loads without conversion, strictly: a missing or
unexpected key raises. Besides: the Multi-Band Diffusion bundle
(`load_diffusion_models`, its configs pickled OmegaConf objects read by a
restricted unpickler), AudioSeal's generator and detector
(`load_audioseal_models`) and JASCO's flow-matching model
(`load_jasco_model`).

Not ported: the Hugging Face EnCodec snapshot format (`config.json` +
`model.safetensors`; ROADMAP).
"""
import _compat_pickle
import json
import os
import pickle
import re
import typing as tp
from collections import OrderedDict
from pathlib import Path

import torch
import yaml

from ..modules.conditioners import ChromaStemConditioner
from . import builders
from ..utils.utils import resolve_device
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


# ------------------------------------------------------ MBD, AudioSeal, JASCO

class _PickledConfig:
    """A stand-in for an OmegaConf class met in a pickle: it keeps the
    state it is given and nothing of the class it stands for."""

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__["_state"] = state


_BUNDLE_GLOBALS = {
    ("collections", "OrderedDict"): OrderedDict,
    ("typing", "Any"): tp.Any,
    ("torch._utils", "_rebuild_tensor_v2"): torch._utils._rebuild_tensor_v2,
    ("torch._utils", "_rebuild_parameter"): torch._utils._rebuild_parameter,
    **{("builtins", t.__name__): t
       for t in (dict, list, tuple, set, int, float, str, bool, object)},
}


class _BundleUnpickler(pickle.Unpickler):
    """Admits omegaconf's classes (as `_PickledConfig` stand-ins), plain
    containers and torch's tensor-rebuild functions; refuses every other
    global, so a bundle cannot run code while it loads."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._standins: tp.Dict[tp.Tuple[str, str], type] = {}

    def find_class(self, module: str, name: str):
        # protocol 2, torch.save's default, names builtins `__builtin__`
        module = _compat_pickle.IMPORT_MAPPING.get(module, module)
        if module == "omegaconf" or module.startswith("omegaconf."):
            key = (module, name)
            if key not in self._standins:
                self._standins[key] = type(name, (_PickledConfig,), {})
            return self._standins[key]
        if (module, name) in _BUNDLE_GLOBALS:
            return _BUNDLE_GLOBALS[(module, name)]
        raise pickle.UnpicklingError(
            f"refusing to load {module}.{name} from a diffusion bundle")


class _BundlePickle:
    """The pickle module `torch.load` reads a diffusion bundle with."""
    Unpickler = _BundleUnpickler

    @staticmethod
    def load(file, **kwargs):
        return _BundleUnpickler(file, **kwargs).load()


def _plain_config(obj):
    """Unwrap pickled OmegaConf containers (their `_content`) and nodes
    (their `_val`) into dicts, lists and scalars."""
    if isinstance(obj, _PickledConfig):
        state = obj.__dict__
        if "_content" in state:
            return _plain_config(state["_content"])
        return _plain_config(state.get("_val"))
    if isinstance(obj, dict):
        return {k: _plain_config(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain_config(v) for v in obj]
    return obj


def load_diffusion_models(name: str, filename: tp.Optional[str] = None,
                          device=None):
    """The Multi-Band Diffusion bundle at `name` (a file, or `filename`
    (default the first `*.th`, then `*.pt`) in a directory):
    `{'sample_rate', 'n_bands', i: {'cfg', 'model_state',
    'processor_state'}}`. Returns (models, schedules, cfgs, sample_rate),
    one model and schedule (with its band processor's statistics) per
    band. Each `cfg` is a pickled OmegaConf `DictConfig`, read by an
    unpickler that admits only omegaconf's containers (kept as plain
    state), plain containers and tensors."""
    path = _resolve(name)
    if path.is_dir():
        found = sorted(path.glob(filename or "*.th")) + sorted(path.glob("*.pt"))
        if not found:
            raise FileNotFoundError(f"no MBD checkpoint found in {path}")
        path = found[0]
    device = resolve_device(device)
    pkg = torch.load(path, map_location="cpu", weights_only=False,
                     pickle_module=_BundlePickle)
    sample_rate = pkg["sample_rate"]
    models, schedules, cfgs = [], [], []
    for i in range(pkg["n_bands"]):
        cfg = _resolve_interpolations(_plain_config(pkg[i]["cfg"]))
        model, schedule = builders.get_diffusion_band(cfg, sample_rate,
                                                      device=device)
        model.load_state_dict(pkg[i]["model_state"], strict=True)
        # upstream's julius band splitter keeps its filter bank as a buffer;
        # the port computes it
        stats = {k: v for k, v in (pkg[i].get("processor_state") or {}).items()
                 if not k.startswith("split_bands.")}
        schedule.sample_processor.load_state_dict(stats, strict=True)
        models.append(model.eval())
        schedules.append(schedule)
        cfgs.append(cfg)
    return models, schedules, cfgs, sample_rate


def load_audioseal_models(name: str, filename: str = "base", device=None):
    """AudioSeal from the snapshot directory at `name`:
    `generator_<filename>.pth` and `detector_<filename>.pth`, each
    `{'model': state_dict}` (read with `weights_only=True`), and an optional
    `<filename>.json` config (`nbits`, `seanet`, `detector.output_dim`)."""
    from .watermark import AudioSeal, AudioSealDetector, AudioSealWM
    path = _resolve(name)
    if not path.is_dir():
        raise NotADirectoryError(f"expected an audioseal snapshot directory, "
                                 f"got {path}")
    cfg: dict = {}
    if (path / f"{filename}.json").exists():
        cfg = json.loads((path / f"{filename}.json").read_text())
    seanet = dict(cfg.get("seanet") or {})
    kw = dict(nbits=cfg.get("nbits", 16),
              dimension=seanet.get("dimension", 128),
              n_filters=seanet.get("n_filters", 32),
              n_residual_layers=seanet.get("n_residual_layers", 1),
              lstm=seanet.get("lstm", 2),
              ratios=tuple(seanet.get("ratios", (8, 5, 4, 2))))
    device = resolve_device(device)
    generator = AudioSealWM(device=device, **kw)
    detector = AudioSealDetector(
        output_dim=(cfg.get("detector") or {}).get("output_dim", 32),
        device=device, **kw)
    for module, kind in ((generator, "generator"), (detector, "detector")):
        ckpt = torch.load(path / f"{kind}_{filename}.pth", map_location="cpu",
                          weights_only=True)
        if "model" not in ckpt:
            raise KeyError(f"no model state dict in {kind}_{filename}.pth")
        module.load_state_dict(ckpt["model"], strict=True)
    return AudioSeal(generator, detector, nbits=kw["nbits"], device=device)


def load_jasco_model(name: str, device=None):
    """(FlowMatchingModel, config) of the JASCO export package at `name`
    (`state_dict.bin` or `*.th`), built by `builders.get_jasco_model`."""
    state, cfg = load_package(_package_file(
        _resolve(name), ("state_dict.bin", "*.th")))
    model = builders.get_jasco_model(cfg, device=device)
    model.load_state_dict(state, strict=True)
    return model.eval(), cfg
