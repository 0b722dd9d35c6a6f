"""Model presets (counterpart of `audiocraft_tpu/models/presets.py`)."""
import typing as tp

from ..modules.conditioners import (BaseConditioner, ConditionFuser,
                                    LUTConditioner, T5Conditioner)
from ..modules.patterns import DelayedPatternProvider
from .lm import LMModel

MODEL_SCALES = {
    "xsmall": dict(dim=64, num_heads=2, num_layers=2),
    "small": dict(dim=1024, num_heads=16, num_layers=24),
    "medium": dict(dim=1536, num_heads=24, num_layers=48),
    "large": dict(dim=2048, num_heads=32, num_layers=48),
}


def musicgen_lm(scale: str = "small", n_q: int = 4, card: int = 2048,
                conditioners: tp.Optional[tp.Dict[str, BaseConditioner]] = None,
                use_t5: bool = False,
                delays: tp.Optional[tp.List[int]] = None, device=None,
                dtype=None, **overrides) -> LMModel:
    """MusicGen LM: delay pattern (codebook q delayed by `delays[q]`,
    default q), text conditioning by cross-attention (T5-base, or a lookup
    table), pre-norm, no biases, CFG coefficient 3."""
    kw = dict(MODEL_SCALES[scale])
    dim = kw["dim"]
    factory = dict(device=device, dtype=dtype)
    if conditioners is None:
        if use_t5:
            conditioners = {"description": T5Conditioner(
                "t5-base", output_dim=dim, **factory)}
        else:
            conditioners = {"description": LUTConditioner(
                n_bins=2048, dim=dim, output_dim=dim, **factory)}
    fuser = ConditionFuser({"cross": ["description"], "prepend": [], "sum": [],
                            "input_interpolate": []})
    kw.update(n_q=n_q, card=card, cross_attention=True, causal=True,
              norm_first=True, bias_proj=False, bias_ff=False, bias_attn=False,
              cfg_coef=3.0)
    kw.update(overrides)
    return LMModel(DelayedPatternProvider(n_q=n_q, delays=delays), conditioners,
                   fuser, **kw, **factory)
