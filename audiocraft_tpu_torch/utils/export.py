"""Trained checkpoints as audiocraft export packages (counterpart of
`audiocraft_tpu/utils/export.py`).

A package is a torch pickle of {'best_state': state dict (CPU tensors),
'xp.cfg': the solver config as a dict, 'version', 'exported': True}, the
layout of upstream audiocraft's exports: `models/loaders.py` reads it
(`load_lm_model`, `load_compression_model`), and so do the JAX package's
converters. A solver checkpoint's config is read from the `config.json`
that `train.py` writes beside it unless the caller gives one.
"""
import json
import typing as tp
from pathlib import Path

import torch

VERSION = "audiocraft_tpu_torch"


def _cpu_state(state: tp.Mapping[str, torch.Tensor]) -> dict:
    return {k: v.detach().cpu() for k, v in state.items()}


def save_package(state: tp.Mapping[str, torch.Tensor], cfg: dict,
                 out_file: tp.Union[Path, str]) -> Path:
    """Write an export package."""
    out_file = Path(out_file)
    out_file.parent.mkdir(exist_ok=True, parents=True)
    torch.save({"best_state": _cpu_state(state), "xp.cfg": dict(cfg),
                "version": VERSION, "exported": True}, out_file)
    return out_file


def _solver_checkpoint(checkpoint_path: tp.Union[Path, str],
                       cfg: tp.Optional[dict]) -> tp.Tuple[dict, dict]:
    path = Path(checkpoint_path)
    pkg = torch.load(path, map_location="cpu", weights_only=True)
    if cfg is None:
        sidecar = path.parent / "config.json"
        if not sidecar.exists():
            raise FileNotFoundError(f"no config given and no {sidecar}")
        cfg = json.loads(sidecar.read_text())
    return pkg, cfg


def export_lm(checkpoint_path: tp.Union[Path, str],
              out_file: tp.Union[Path, str],
              cfg: tp.Optional[dict] = None) -> Path:
    """The LM of a MusicGen-family solver checkpoint (its best state when
    it keeps one, else its weights) as a package (`state_dict.bin`). The
    config must build the LM (`transformer_lm`)."""
    pkg, cfg = _solver_checkpoint(checkpoint_path, cfg)
    if not cfg.get("transformer_lm"):
        raise ValueError("the config has no transformer_lm: the debug LM "
                         "cannot be rebuilt from a package")
    state = pkg.get("best_state") or pkg["model"]
    return save_package(state, cfg, out_file)


def export_encodec(checkpoint_path: tp.Union[Path, str],
                   out_file: tp.Union[Path, str],
                   cfg: tp.Optional[dict] = None) -> Path:
    """The codec of a compression solver checkpoint as a package
    (`compression_state_dict.bin`); its config is the codec's own
    (`xp.cfg` in the checkpoint) unless the caller gives one."""
    path = Path(checkpoint_path)
    pkg = torch.load(path, map_location="cpu", weights_only=True)
    cfg = cfg or pkg.get("xp.cfg")
    if cfg is None:
        raise ValueError(f"{path} holds no codec config")
    return save_package(pkg.get("best_state") or pkg["model"], cfg, out_file)


def export_pretrained_compression_model(name: str,
                                        out_file: tp.Union[Path, str]) -> Path:
    """A codec that `models.loaders.load_compression_model` reads (a
    package, a JAX export or a Hugging Face snapshot) as a package."""
    from ..models import loaders
    model = loaders.load_compression_model(name, device="cpu")
    return save_package(model.state_dict(), encodec_model_cfg(model),
                        out_file)


def encodec_model_cfg(model) -> dict:
    """The builder config of a live EnCodec model (`compression_model:
    encodec`), so that a package of it loads on its own."""
    enc, q = model.encoder, model.quantizer
    seanet = {key: getattr(enc, key) for key in (
        "dimension", "channels", "n_filters", "n_residual_layers", "norm",
        "kernel_size", "residual_kernel_size", "last_kernel_size",
        "dilation_base", "causal", "pad_mode", "true_skip", "compress",
        "lstm") if hasattr(enc, key)}
    seanet["ratios"] = list(enc.ratios)
    return {"compression_model": "encodec", "encodec": {
        "autoencoder": "seanet", "quantizer": "rvq",
        "sample_rate": model.sample_rate, "channels": model.channels,
        "causal": getattr(model, "causal", False),
        "renormalize": bool(getattr(model, "renormalize", False)),
        "seanet": seanet,
        "rvq": {"n_q": q.n_q, "bins": q.bins, "kmeans_init": False}}}
