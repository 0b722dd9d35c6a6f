"""Checkpoint loading from local paths (counterpart of
`audiocraft_tpu/models/loaders.py`).

Nothing is downloaded: a name is a path, or a path under
`AUDIOCRAFT_CACHE_DIR`. The files are audiocraft's export packages, which
the JAX package reads too: `*.th`, `state_dict.bin` (the LM) and
`compression_state_dict.bin` (the codec), each a torch pickle holding
`best_state` (the state dict) and `xp.cfg` (the solver config, a dict or
its YAML text). The port's modules keep upstream's names and state-dict
keys, so a package loads without conversion, strictly: a missing or
unexpected key raises. One exception: upstream's T5 conditioner keeps its
encoder out of the state dict, so a released LM package has no
`...<name>.t5.*` keys; an LM package may lack exactly those, and the
encoder keeps the builder's seeded init (the JAX package leaves it out of
the parameters, and its generate then raises).

A codec also loads from the JAX package's own export (`*.npz` written by
`audiocraft_tpu/utils/export.py`: flattened `a/b/c` arrays beside a
`__meta__` JSON of the builder config), and from a Hugging Face EnCodec
snapshot (`config.json` with `model_type: encodec`, and `model.safetensors`
read by `utils/safetensors.py`, or `pytorch_model.bin`), its keys renamed to
upstream's. Besides: the Multi-Band Diffusion bundle
(`load_diffusion_models`, its configs pickled OmegaConf objects read by a
restricted unpickler), AudioSeal's generator and detector
(`load_audioseal_models`) and JASCO's flow-matching model
(`load_jasco_model`).
"""
import _compat_pickle
import json
import os
import pickle
import re
import typing as tp
from collections import OrderedDict
from pathlib import Path

import numpy as np
import torch
import yaml

from ..modules.conditioners import ChromaStemConditioner, T5Conditioner
from ..modules.conv import StreamableConv1d, StreamableConvTranspose1d
from ..modules.seanet import SEANetResnetBlock
from ..utils import checkpoint, jax_weights, safetensors
from ..utils.utils import resolve_device
from . import builders
from .encodec import CompressionModel, EncodecModel
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
    """The codec at `name`: a Hugging Face EnCodec snapshot (a directory
    whose `config.json` says `model_type: encodec`), else the first of
    `*.th`, `*.npz` (a JAX export) and `compression_state_dict.bin` in a
    directory, or the file itself, as the JAX package looks them up. An
    audiocraft package's config may hold `seanet`, `rvq`, `sample_rate` and
    `channels` at its top level (audiocraft's exports) or under `encodec`;
    its convolutions are weight-normed unless it says otherwise."""
    path = _resolve(name)
    if path.is_dir() and (path / "config.json").exists():
        hf_cfg = json.loads((path / "config.json").read_text())
        if hf_cfg.get("model_type") == "encodec":
            return load_hf_encodec(path, device=device)
    path = _package_file(path, ("*.th", "*.npz", "compression_state_dict.bin"))
    if path.suffix == ".npz":
        return load_exported_compression_model(path, device=device)
    state, cfg = load_package(path)
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


def load_exported_compression_model(path: tp.Union[str, Path],
                                    device=None) -> EncodecModel:
    """The codec of a JAX `export_encodec` package (read with
    `allow_pickle=False`): built from the builder config in its `__meta__`
    JSON by `builders.get_compression_model`, its flattened variables
    (`params/{encoder,decoder}/...`, `quantizer/codebooks/...`) carried in
    by `jax_weights.load_encodec`."""
    with np.load(path, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files}
    meta = json.loads(flat.pop("__meta__").tobytes().decode()) \
        if "__meta__" in flat else {}
    if not meta.get("exported"):
        raise ValueError(f"{path} is not an exported inference checkpoint")
    model = builders.get_compression_model(meta["xp.cfg"], device=device)
    jax_weights.load_encodec(model, checkpoint.unflatten(flat))
    return model


def _hf_weights(path: Path) -> tp.Dict[str, torch.Tensor]:
    if (path / "model.safetensors").exists():
        return safetensors.load_file(path / "model.safetensors")
    for filename in ("pytorch_model.bin", "model.bin"):
        if (path / filename).exists():
            return dict(torch.load(path / filename, map_location="cpu",
                                   weights_only=True))
    raise FileNotFoundError(f"no model.safetensors or pytorch_model.bin in "
                            f"{path}")


def _hf_encodec_model(cfg: dict, n_q: int, device) -> EncodecModel:
    """The EnCodec of a Hugging Face `EncodecConfig`, with the widths the
    JAX package's `load_hf_encodec_from_dir` reads."""
    seanet = dict(
        dimension=cfg.get("hidden_size", 128),
        n_filters=cfg.get("num_filters", 32),
        n_residual_layers=cfg.get("num_residual_layers", 1),
        ratios=list(cfg["upsampling_ratios"]),
        lstm=cfg.get("num_lstm_layers", 2),
        kernel_size=cfg.get("kernel_size", 7),
        last_kernel_size=cfg.get("last_kernel_size", 7),
        residual_kernel_size=cfg.get("residual_kernel_size", 3),
        dilation_base=cfg.get("dilation_growth_rate", 2),
        causal=cfg.get("use_causal_conv", True),
        true_skip=not cfg.get("use_conv_shortcut", True),
        norm="weight_norm" if cfg.get("norm_type") == "weight_norm"
        else "none")
    channels = cfg.get("audio_channels", 1)
    return builders.get_compression_model({"encodec": {
        "sample_rate": cfg.get("sampling_rate", 32000), "channels": channels,
        "renormalize": cfg.get("normalize", False),
        "seanet": dict(seanet, channels=channels),
        "rvq": {"n_q": n_q, "bins": cfg.get("codebook_size", 1024)}}},
        device=device)


def convert_hf_encodec_state(src: tp.Mapping[str, torch.Tensor],
                             model: EncodecModel) -> tp.Dict[str, torch.Tensor]:
    """Hugging Face `EncodecModel` keys -> upstream's, the layer kinds read
    off `model`: `{tower}.layers.{i}.conv.*` -> `{tower}.model.{i}.conv.conv.*`
    (a transposed convolution's -> `convtr.convtr.*`), residual blocks'
    `block.{j}.conv.*` and `shortcut.conv.*` likewise, LSTMs unchanged,
    weight norm's `parametrizations.weight.original0/1` -> `weight_g/v`,
    `quantizer.layers.{q}.codebook.*` -> `quantizer.vq.layers.{q}._codebook.*`.
    """
    out = {}
    for key, value in src.items():
        k = key.replace(".parametrizations.weight.original0", ".weight_g")
        k = k.replace(".parametrizations.weight.original1", ".weight_v")
        if k.startswith("quantizer.layers."):
            k = k.replace("quantizer.layers.", "quantizer.vq.layers.", 1)
            k = k.replace(".codebook.", "._codebook.", 1)
        elif k.split(".")[1:2] == ["layers"]:
            tower, _, idx, tail = k.split(".", 3)
            layer = getattr(model, tower).model[int(idx)]
            parts = tail.split(".")
            if isinstance(layer, StreamableConvTranspose1d):
                parts[0] = "convtr.convtr"
            elif isinstance(layer, (StreamableConv1d, SEANetResnetBlock)):
                ci = parts.index("conv")
                parts[ci] = "conv.conv"
            k = ".".join([tower, "model", idx] + parts)
        out[k] = value
    return out


def hf_encodec_state_dict(model: EncodecModel) -> tp.Dict[str, torch.Tensor]:
    """A port EnCodec's state dict under Hugging Face's names, with every
    convolution weight-normed as Hugging Face's are (a plain weight `w` is
    written as `original0` = its norm per output row and `original1` = `w`):
    the inverse of `convert_hf_encodec_state`."""
    out = {}
    for key, value in model.state_dict().items():
        k = key
        if k.startswith("quantizer.vq.layers."):
            k = k.replace("quantizer.vq.layers.", "quantizer.layers.", 1)
            k = k.replace("._codebook.", ".codebook.", 1)
            out[k] = value
            continue
        k = k.replace(".model.", ".layers.", 1)
        k = k.replace("convtr.convtr.", "conv.", 1).replace("conv.conv.",
                                                            "conv.", 1)
        if k.endswith(".weight_g") or k.endswith(".weight_v"):
            suffix = "original0" if k.endswith("_g") else "original1"
            k = k[:-len(".weight_g")] + ".parametrizations.weight." + suffix
        elif k.endswith(".conv.weight"):
            base = k[:-len(".weight")] + ".parametrizations.weight."
            out[base + "original0"] = value.square().sum(
                dim=(1, 2), keepdim=True).sqrt()
            k = base + "original1"
        out[k] = value
    return out


def load_hf_encodec(path: tp.Union[str, Path], device=None) -> EncodecModel:
    """The EnCodec of a Hugging Face snapshot directory (`config.json` +
    `model.safetensors` or `pytorch_model.bin`), e.g. facebook/encodec_32khz,
    the codec MusicGen's Hugging Face checkpoints ship with: the widths from
    the config, `n_q` from the quantizer's keys, loaded strictly."""
    path = Path(path)
    cfg = json.loads((path / "config.json").read_text())
    if cfg.get("model_type") != "encodec":
        raise ValueError(f"{path} holds a {cfg.get('model_type')!r} model, "
                         f"not encodec")
    src = _hf_weights(path)
    n_q = len({k.split(".")[2] for k in src if k.startswith("quantizer.")})
    model = _hf_encodec_model(cfg, n_q, resolve_device(device))
    model.load_state_dict(convert_hf_encodec_state(src, model), strict=True)
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
    own = model.state_dict()
    for cond_name, cond in model.condition_provider.conditioners.items():
        prefix = f"condition_provider.conditioners.{cond_name}."
        if isinstance(cond, ChromaStemConditioner):
            # a melody conditioner's chroma filter bank and window are
            # computed, not loaded: drop them where an export carries them
            state = {k: v for k, v in state.items()
                     if not k.startswith(prefix + "chroma.")}
        elif isinstance(cond, T5Conditioner):
            # upstream keeps the T5 encoder out of the state dict: without
            # any of its keys it keeps the seeded init
            t5_keys = [k for k in own if k.startswith(prefix + "t5.")]
            if not any(k in state for k in t5_keys):
                state = {**{k: own[k] for k in t5_keys}, **state}
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
