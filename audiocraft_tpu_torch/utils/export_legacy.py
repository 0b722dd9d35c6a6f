"""First-release audiocraft training checkpoints as export packages
(counterpart of `audiocraft_tpu/utils/export_legacy.py`).

Those runs kept the codec under `ema.state.model` and the LM under
`fsdp_best_state.model` (or `best_state.model`), beside a pickled OmegaConf
config that lacks the LM's `card` and `n_q` and carries parameters removed
since. The pickle is read by the loaders' restricted unpickler (OmegaConf
objects become plain containers; nothing else is constructed), and the
result is an export package of `utils/export.py`.
"""
import typing as tp
from pathlib import Path

import torch

from .export import save_package

_REMOVED_LM_KEYS = ("spectral_norm_attn_iters", "spectral_norm_ff_iters",
                    "residual_balancer_attn", "residual_balancer_ff",
                    "layer_drop")


def _load_pkg(checkpoint_path: tp.Union[Path, str]) -> dict:
    from ..models.loaders import _BundlePickle, _plain_config
    try:
        pkg = torch.load(checkpoint_path, map_location="cpu",
                         weights_only=True)
    except Exception:  # an OmegaConf config: the restricted unpickler
        pkg = torch.load(checkpoint_path, map_location="cpu",
                         pickle_module=_BundlePickle, weights_only=False)
    return {k: (_plain_config(v) if k == "xp.cfg" else v)
            for k, v in pkg.items()}


def _clean_lm_cfg(cfg: dict) -> dict:
    """The LM config of a first-release run: `card` 2048, `n_q` 4 (8 with
    interleaved stereo codebooks, whose `downsample` goes), and the removed
    parameters dropped."""
    cfg = dict(cfg)
    lm = {k: v for k, v in dict(cfg.get("transformer_lm", {})).items()
          if k not in _REMOVED_LM_KEYS}
    lm["card"] = 2048
    lm["n_q"] = 4
    stereo = dict(cfg.get("interleave_stereo_codebooks", {}) or {})
    if stereo.get("use"):
        stereo.pop("downsample", None)
        cfg["interleave_stereo_codebooks"] = stereo
        lm["n_q"] = 8
    cfg["transformer_lm"] = lm
    return cfg


def export_encodec(checkpoint_path: tp.Union[Path, str],
                   out_file: tp.Union[Path, str]) -> Path:
    """A legacy codec training checkpoint (its EMA weights) as a package."""
    pkg = _load_pkg(checkpoint_path)
    return save_package(pkg["ema"]["state"]["model"], pkg["xp.cfg"],
                        out_file)


def export_lm(checkpoint_path: tp.Union[Path, str],
              out_file: tp.Union[Path, str]) -> Path:
    """A legacy LM training checkpoint (the consolidated FSDP best state,
    else the best state) as a package, its config cleaned."""
    pkg = _load_pkg(checkpoint_path)
    best = pkg.get("fsdp_best_state") or pkg["best_state"]
    return save_package(best["model"], _clean_lm_cfg(pkg["xp.cfg"]),
                        out_file)
