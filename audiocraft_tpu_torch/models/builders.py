"""Model builders with seeded random weights (counterpart of the debug and
MusicGen-small assemblies in `audiocraft_tpu/models/builders.py` and
`bench.py`)."""
import contextlib

import torch

from ..modules.conditioners import ConditionFuser, LUTConditioner
from ..modules.patterns import DelayedPatternProvider
from ..modules.seanet import SEANetDecoder, SEANetEncoder
from ..quantization import ResidualVectorQuantizer
from ..utils.utils import resolve_device
from .encodec import EncodecModel
from .lm import LMModel
from .presets import musicgen_lm


@contextlib.contextmanager
def _seeded(device: torch.device, seed: int):
    """Seed a fork of the global RNG (CPU and `device`), so that torch's
    default initialisers give the same weights for the same seed."""
    with torch.random.fork_rng(devices=[device] if device.type == "cuda"
                               else []):
        torch.manual_seed(seed)
        yield


def get_encodec(sample_rate: int, ratios, n_filters: int, dimension: int,
                n_residual_layers: int, lstm: int, n_q: int, bins: int,
                frame_rate: int, norm: str = "none", device=None, dtype=None,
                seed: int = 0) -> EncodecModel:
    device = resolve_device(device)
    kw = dict(n_filters=n_filters, n_residual_layers=n_residual_layers,
              dimension=dimension, ratios=tuple(ratios), lstm=lstm, norm=norm,
              device=device, dtype=dtype)

    with _seeded(device, seed):
        model = EncodecModel(SEANetEncoder(**kw), SEANetDecoder(**kw),
                             ResidualVectorQuantizer(dimension, n_q, bins,
                                                     device=device),
                             frame_rate=frame_rate, sample_rate=sample_rate,
                             channels=1)
        model.reset_parameters(seed)
    return model.eval()


def get_debug_compression_model(device=None, seed: int = 0) -> EncodecModel:
    """Tiny 32 kHz codec at 25 Hz, as the JAX package's debug codec."""
    return get_encodec(32000, (10, 8, 16), n_filters=4, dimension=32,
                       n_residual_layers=1, lstm=0, n_q=4, bins=400,
                       frame_rate=25, device=device, seed=seed)


def get_encodec_32khz(device=None, dtype=None, seed: int = 0) -> EncodecModel:
    """EnCodec 32 kHz at full width: SEANet dimension 128, 64 filters,
    ratios (8, 5, 4, 4) (hop 640, 50 Hz), 2 LSTM layers, 4 x 2048 codes."""
    return get_encodec(32000, (8, 5, 4, 4), n_filters=64, dimension=128,
                       n_residual_layers=1, lstm=2, n_q=4, bins=2048,
                       frame_rate=50, device=device, dtype=dtype, seed=seed)


def get_debug_lm_model(device=None, seed: int = 0) -> LMModel:
    """Tiny LM: dim 16, 4 heads, 2 post-norm layers, 4 x 400 codes, lookup
    table text conditioning."""
    device = resolve_device(device)

    with _seeded(device, seed):
        conditioners = {"description": LUTConditioner(
            n_bins=128, dim=16, output_dim=16, device=device)}
        fuser = ConditionFuser({"cross": ["description"], "prepend": [],
                                "sum": [], "input_interpolate": []})
        return LMModel(DelayedPatternProvider(n_q=4), conditioners, fuser,
                       n_q=4, card=400, dim=16, num_heads=4, num_layers=2,
                       cross_attention=True, causal=True, device=device).eval()


def get_musicgen_small_lm(device=None, dtype=torch.bfloat16,
                          seed: int = 0) -> LMModel:
    """MusicGen-small LM at full width (dim 1024, 16 heads, 24 layers,
    FFN 4096, 4 x 2048 codes) conditioned on a T5-base encoder."""
    device = resolve_device(device)

    with _seeded(device, seed):
        lm = musicgen_lm("small", n_q=4, card=2048, use_t5=True,
                         device=device, dtype=dtype)
    lm.reset_parameters(seed)
    return lm.eval()
