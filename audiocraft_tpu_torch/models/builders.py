"""Model builders with seeded random weights (counterpart of the debug and
MusicGen-small assemblies in `audiocraft_tpu/models/builders.py` and
`bench.py`, of its config-driven `get_lm_model` and `get_jasco_model`, and
of `get_wrapped_compression_model`), the full-width MusicGen-melody,
MusicGen-Style, AudioGen-medium and MAGNeT-small LMs from their solver
configs, and the full-width Multi-Band Diffusion, AudioSeal and JASCO
models of the smoke run."""
import contextlib
import typing as tp

import torch

from ..config import load_config
from ..modules.conditioners import (BaseConditioner, CLAPEmbeddingConditioner,
                                    ChromaStemConditioner,
                                    ConditionFuser, LUTConditioner,
                                    StyleConditioner, T5Conditioner,
                                    bind_feat_extractor)
from ..modules.diffusion_schedule import MultiBandProcessor, NoiseSchedule
from ..modules.jasco_conditioners import (ChordsEmbConditioner,
                                          DrumsConditioner, MelodyConditioner)
from ..modules.mert import MERTModel
from ..modules.patterns import (CoarseFirstPattern, CodebooksPatternProvider,
                                DelayedPatternProvider, MusicLMPattern,
                                ParallelPatternProvider,
                                UnrolledPatternProvider)
from ..modules.seanet import SEANetDecoder, SEANetEncoder
from ..quantization import DummyQuantizer, ResidualVectorQuantizer
from ..utils.utils import resolve_device
from .encodec import (CompressionModel, EncodecModel,
                      InterleaveStereoCompressionModel)
from .flow_matching import FlowMatchingModel
from .jasco import JASCO
from .lm import LMModel
from .lm_magnet import MagnetLMModel
from .multibanddiffusion import DiffusionProcess, MultiBandDiffusion
from .presets import musicgen_lm
from .unet import DiffusionUnet
from .watermark import AudioSeal, AudioSealDetector, AudioSealWM


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


def get_compression_model(cfg: dict, device=None) -> EncodecModel:
    """The EnCodec model of a config (`compression_model: encodec` with an
    `encodec` group: `seanet` with its `encoder`/`decoder` overrides, the
    `rvq` quantizer or `no_quant`, `sample_rate`, `channels`, `causal`,
    `renormalize`), as the JAX package's `get_compression_model` builds
    it; torch's default init. The RVQ's training settings (`decay`,
    `kmeans_init`, `threshold_ema_dead_code`, `q_dropout`) are taken; its
    `kmeans_iters` and orthogonal terms are accepted and unused, as in the
    JAX package."""
    device = resolve_device(device)
    if cfg.get("compression_model", "encodec") != "encodec":
        raise KeyError(f"unexpected compression model "
                       f"{cfg.get('compression_model')!r}")
    enc = dict(cfg.get("encodec", {}) or {})
    quantizer_name = enc.get("quantizer", "rvq")
    if enc.get("autoencoder", "seanet") != "seanet" or \
            quantizer_name not in ("rvq", "no_quant"):
        raise NotImplementedError(f"only the seanet autoencoder and the rvq "
                                  f"and no_quant quantizers are ported, got "
                                  f"{enc}")
    seanet = dict(enc.get("seanet", {}) or {})
    overrides = {part: dict(seanet.pop(part, {}) or {})
                 for part in ("encoder", "decoder")}
    for key in ("ratios", "kernel_sizes", "dilations"):
        if key in seanet:
            seanet[key] = tuple(seanet[key])
    encoder = SEANetEncoder(**{**seanet, **overrides["encoder"]},
                            device=device)
    decoder = SEANetDecoder(**{**seanet, **overrides["decoder"]},
                            device=device)
    if quantizer_name == "no_quant":
        quantizer = DummyQuantizer()
    else:
        rvq = dict(enc.get("rvq", {}) or {})
        rvq.pop("dimension", None)
        quantizer = ResidualVectorQuantizer(
            encoder.dimension, rvq.pop("n_q", 8), rvq.pop("bins", 1024),
            device=device, kmeans_init=rvq.pop("kmeans_init", True), **rvq)
    sample_rate = enc["sample_rate"]
    return EncodecModel(encoder, decoder, quantizer,
                        frame_rate=sample_rate // encoder.hop_length,
                        sample_rate=sample_rate, channels=enc["channels"],
                        causal=enc.get("causal", False),
                        renormalize=bool(enc.get("renormalize", False))
                        ).eval()


DEBUG_CODEC_RATIOS = {16000: (10, 8, 8), 32000: (10, 8, 16)}  # 25 Hz


def get_debug_compression_model(device=None, seed: int = 0,
                                sample_rate: int = 32000) -> EncodecModel:
    """Tiny codec at 25 Hz (32 kHz, or 16 kHz for AudioGen), as the JAX
    package's debug codec."""
    return get_encodec(sample_rate, DEBUG_CODEC_RATIOS[sample_rate],
                       n_filters=4, dimension=32, n_residual_layers=1, lstm=0,
                       n_q=4, bins=400, frame_rate=25, device=device,
                       seed=seed)


def get_encodec_32khz(device=None, dtype=None, seed: int = 0) -> EncodecModel:
    """EnCodec 32 kHz at full width: SEANet dimension 128, 64 filters,
    ratios (8, 5, 4, 4) (hop 640, 50 Hz), 2 LSTM layers, 4 x 2048 codes."""
    return get_encodec(32000, (8, 5, 4, 4), n_filters=64, dimension=128,
                       n_residual_layers=1, lstm=2, n_q=4, bins=2048,
                       frame_rate=50, device=device, dtype=dtype, seed=seed)


def get_encodec_16khz(device=None, dtype=None, seed: int = 0) -> EncodecModel:
    """AudioGen's EnCodec 16 kHz at full width
    (`solver/compression/encodec_audiogen_16khz`): SEANet dimension 128, 64
    filters, ratios (8, 5, 4, 4) (hop 640, 25 Hz), 2 LSTM layers,
    4 x 2048 codes."""
    return get_encodec(16000, (8, 5, 4, 4), n_filters=64, dimension=128,
                       n_residual_layers=1, lstm=2, n_q=4, bins=2048,
                       frame_rate=25, device=device, dtype=dtype, seed=seed)


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


def get_debug_stereo_lm_model(device=None, seed: int = 0) -> LMModel:
    """The debug LM over interleaved stereo codebooks: 8 x 400 codes with
    the default delays 0..7, as the JAX package's debug stereo LM."""
    device = resolve_device(device)

    with _seeded(device, seed):
        conditioners = {"description": LUTConditioner(
            n_bins=128, dim=16, output_dim=16, device=device)}
        fuser = ConditionFuser({"cross": ["description"], "prepend": [],
                                "sum": [], "input_interpolate": []})
        return LMModel(DelayedPatternProvider(n_q=8), conditioners, fuser,
                       n_q=8, card=400, dim=16, num_heads=4, num_layers=2,
                       cross_attention=True, causal=True, device=device).eval()


def get_debug_melody_lm_model(device=None, seed: int = 0) -> LMModel:
    """The debug LM with a melody condition, as the JAX package's debug
    melody LM: the chroma of 2^10-point frames (duration 1 s, 12 classes)
    prepended, the text by cross-attention."""
    device = resolve_device(device)

    with _seeded(device, seed):
        conditioners = {
            "description": LUTConditioner(n_bins=128, dim=16, output_dim=16,
                                          device=device),
            "self_wav": ChromaStemConditioner(
                output_dim=16, sample_rate=32000, n_chroma=12, radix2_exp=10,
                duration=1.0, device=device)}
        fuser = ConditionFuser({"cross": ["description"],
                                "prepend": ["self_wav"], "sum": [],
                                "input_interpolate": []})
        return LMModel(DelayedPatternProvider(n_q=4), conditioners, fuser,
                       n_q=4, card=400, dim=16, num_heads=4, num_layers=2,
                       cross_attention=True, causal=True, device=device).eval()


def get_debug_style_lm_model(device=None, seed: int = 0) -> LMModel:
    """The debug LM with a style condition, as the JAX package's debug
    style LM: a style conditioner over the debug codec's 4 code streams
    (excerpt 0.05 s, transformer 'xsmall', 3 RVQ streams of 64 codes, 2 at
    eval, every 2nd step) prepended, the text by cross-attention."""
    device = resolve_device(device)

    with _seeded(device, seed):
        style = StyleConditioner(
            output_dim=16, dim=256, sample_rate=32000,
            transformer_scale="xsmall", ds_factor=2, n_q_out=3, eval_q=2,
            length=0.05, encodec_n_q=4, bins=64, device=device)
        conditioners = {
            "description": LUTConditioner(n_bins=128, dim=16, output_dim=16,
                                          device=device),
            "self_wav": style}
        fuser = ConditionFuser({"cross": ["description"],
                                "prepend": ["self_wav"], "sum": [],
                                "input_interpolate": []})
        lm = LMModel(DelayedPatternProvider(n_q=4), conditioners, fuser,
                     n_q=4, card=400, dim=16, num_heads=4, num_layers=2,
                     cross_attention=True, causal=True, device=device)
    bind_feat_extractor(style, get_debug_compression_model(device=device,
                                                           seed=seed))
    return lm.eval()


def get_debug_magnet_lm_model(device=None, seed: int = 0) -> MagnetLMModel:
    """The debug MAGNeT LM, as the JAX package's: the debug LM's widths
    over the parallel pattern, non-causal, text by cross-attention,
    context +-5 steps after the first stage, spans of 3, 25 Hz."""
    device = resolve_device(device)

    with _seeded(device, seed):
        conditioners = {"description": LUTConditioner(
            n_bins=128, dim=16, output_dim=16, device=device)}
        fuser = ConditionFuser({"cross": ["description"], "prepend": [],
                                "sum": [], "input_interpolate": []})
        return MagnetLMModel(
            ParallelPatternProvider(n_q=4), conditioners, fuser, n_q=4,
            card=400, dim=16, num_heads=4, num_layers=2,
            cross_attention=True, causal=False, subcodes_context=5,
            compression_model_framerate=25, segment_duration=10, span_len=3,
            device=device).eval()


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


# `grids/musicgen/musicgen_stereo_finetune_32khz.py` of the JAX package
STEREO_SMALL_DELAYS = [0, 0, 1, 1, 2, 2, 3, 3]


def get_musicgen_stereo_small_lm(device=None, dtype=torch.bfloat16,
                                 seed: int = 0) -> LMModel:
    """MusicGen-stereo-small LM at full width: the small LM over 8 x 2048
    interleaved stereo codebooks (left and right of each mono level side by
    side) with delays [0, 0, 1, 1, 2, 2, 3, 3], T5-base conditioned."""
    device = resolve_device(device)

    with _seeded(device, seed):
        lm = musicgen_lm("small", n_q=8, card=2048, use_t5=True,
                         delays=STEREO_SMALL_DELAYS, device=device,
                         dtype=dtype)
    lm.reset_parameters(seed)
    return lm.eval()


def _medium_config(solver: str) -> dict:
    """A solver config at the medium model scale (`model/lm/model_scale/
    medium`: dim 1536, 24 heads, 48 layers)."""
    cfg = load_config(solver)
    cfg["transformer_lm"].update(
        load_config("model/lm/model_scale/medium")["transformer_lm"])
    return cfg


def get_musicgen_melody_lm(device=None, dtype=torch.bfloat16,
                           seed: int = 0) -> LMModel:
    """MusicGen-melody's LM at full width, the size of the released
    `facebook/musicgen-melody`: `solver/musicgen/musicgen_melody_32khz` at
    the medium scale (dim 1536, 24 heads, 48 layers, FFN 6144,
    4 x 2048 codes), the chroma (2^14-point frames) and the T5-base text
    both prepended, in that order, no cross-attention. The chroma is
    matched to 30 s (`match_len_on_eval`), as on a loaded melody model."""
    lm = get_lm_model(_medium_config("solver/musicgen/musicgen_melody_32khz"),
                      device=device, seed=seed, dtype=dtype)
    lm.condition_provider.conditioners["self_wav"].match_len_on_eval = True
    return lm


def get_mert_base(device=None, seed: int = 0) -> MERTModel:
    """MERT-v1-95M's encoder at full width (HuBERT-base: hidden 768, 12
    layers, 12 heads, FFN 3072, 7 convs of 512; 24 kHz to 75 Hz) with
    torch's default init, seeded, f32."""
    device = resolve_device(device)
    with _seeded(device, seed):
        return MERTModel(device=device).eval()


def get_musicgen_style_lm(device=None, dtype=torch.bfloat16, seed: int = 0,
                          mert: tp.Optional[MERTModel] = None) -> LMModel:
    """MusicGen-Style's LM at full width, the size of the released
    `facebook/musicgen-style`: `solver/musicgen/musicgen_style_32khz` at
    the medium scale (dim 1536, 24 heads, 48 layers, FFN 6144, 4 x 2048
    codes), the style tokens (MERT features of a 3 s excerpt, transformer
    'default', 6 RVQ streams of 1024 codes, 3 at eval, every 15th step) and
    the T5-base text both prepended, in that order, no cross-attention.
    The style conditioner's MERT is `mert`, else `get_mert_base(seed + 1)`
    (f32)."""
    lm = get_lm_model(_medium_config("solver/musicgen/musicgen_style_32khz"),
                      device=device, seed=seed, dtype=dtype)
    bind_feat_extractor(lm.condition_provider.conditioners["self_wav"],
                        mert if mert is not None
                        else get_mert_base(device, seed + 1))
    return lm


def get_magnet_small_lm(device=None, dtype=torch.bfloat16,
                        seed: int = 0) -> MagnetLMModel:
    """MAGNeT's LM at full width, the size of the released
    `facebook/magnet-small-10secs`: `solver/magnet/magnet_32khz` (dim 1024,
    16 heads, 24 layers, FFN 4096, 4 x 2048 codes over the parallel
    pattern, non-causal, T5-base by cross-attention, spans of 3, context
    +-5 steps after the first stage, 50 Hz, 10 s)."""
    return get_lm_model(load_config("solver/magnet/magnet_32khz"),
                        device=device, seed=seed, dtype=dtype)


def get_audiogen_medium_lm(device=None, dtype=torch.bfloat16,
                           seed: int = 0) -> LMModel:
    """AudioGen's LM at full width, the size of the released
    `facebook/audiogen-medium`: `solver/audiogen/default` (T5-large by
    cross-attention) at the medium scale (dim 1536, 24 heads, 48 layers,
    FFN 6144, 4 x 2048 codes)."""
    return get_lm_model(_medium_config("solver/audiogen/default"),
                        device=device, seed=seed, dtype=dtype)


def get_wrapped_compression_model(compression_model: CompressionModel,
                                  cfg: dict) -> CompressionModel:
    """The stereo interleave wrapper (`interleave_stereo_codebooks.use`,
    with its `per_timestep`) and the `compression_model_n_q` clamp of a
    model config."""
    interleave = dict(cfg.get("interleave_stereo_codebooks") or {})
    if interleave.pop("use", False):
        compression_model = InterleaveStereoCompressionModel(compression_model,
                                                             **interleave)
    n_q = cfg.get("compression_model_n_q")
    if n_q is not None:
        compression_model.set_num_codebooks(n_q)
    return compression_model


# keys that only shape the JAX program or its optimizer (`layer_scan`, `dtype`
# and the per-module lr/weight decay, which the solver reads), or that the
# JAX builder also drops
_DROPPED_LM_KEYS = ("layer_scan", "dtype", "lr", "weight_decay", "emb_lr",
                    "q_modeling", "custom", "memory_efficient", "norm")


def get_condition_fuser(cfg: dict) -> ConditionFuser:
    fuser_cfg = dict(cfg.get("fuser", {}) or {})
    return ConditionFuser({k: fuser_cfg.pop(k)
                           for k in ConditionFuser.FUSING_METHODS
                           if k in fuser_cfg}, **fuser_cfg)


def get_conditioners(output_dim: int, cfg: dict, device=None,
                     dtype=None) -> tp.Dict[str, BaseConditioner]:
    """The conditioners of `cfg['conditioners']`: T5, lookup table, the
    melody's chroma (`chroma_stem`), the style bottleneck (`style`), the
    CLAP joint embedding (`clap`), or JASCO's chords (`chords_emb`), drum
    latents (`drum_latents`) and melody salience (`melody`), which take
    their own `out_dim`."""
    out: tp.Dict[str, BaseConditioner] = {}
    for name, cond_cfg in (cfg.get("conditioners", {}) or {}).items():
        if name == "args":
            continue
        kind = cond_cfg["model"]
        args = dict(cond_cfg.get(kind, {}) or {})
        args.pop("device", None)
        if kind == "t5":
            # accepted and not applied by the JAX package's T5Conditioner
            args.pop("word_dropout", None)
            args.pop("normalize_text", None)
            out[name] = T5Conditioner(model_name=args.pop("name", "t5-base"),
                                      output_dim=output_dim, device=device,
                                      dtype=dtype, **args)
        elif kind == "lut":
            # the JAX package's LUTConditioner defaults to the noop tokenizer
            out[name] = LUTConditioner(output_dim=output_dim,
                                       tokenizer=args.pop("tokenizer", "noop"),
                                       device=device, dtype=dtype, **args)
        elif kind == "chroma_stem":
            out[name] = ChromaStemConditioner(output_dim=output_dim,
                                              device=device, dtype=dtype,
                                              **args)
        elif kind == "style":
            out[name] = StyleConditioner(output_dim=output_dim, device=device,
                                         dtype=dtype, **args)
        elif kind in ("chords_emb", "melody"):
            cls = ChordsEmbConditioner if kind == "chords_emb" \
                else MelodyConditioner
            out[name] = cls(card=args["card"], out_dim=args["out_dim"],
                            device=device, dtype=dtype)
        elif kind == "drum_latents":
            out[name] = DrumsConditioner(
                output_dim=args["out_dim"], device=device, dtype=dtype,
                **{k: v for k, v in args.items() if k in _DRUMS_KEYS})
        elif kind == "clap":
            # the JAX builder drops these: no embedding cache, the attribute
            # is the condition's name, and the RVQ has no k-means
            for key in ("cache_path", "attribute", "kmeans_iters"):
                args.pop(key, None)
            out[name] = CLAPEmbeddingConditioner(
                output_dim=output_dim, device=device, dtype=dtype, **args)
        else:
            raise ValueError(f"Unrecognized conditioning model: {kind}")
    return out


_DRUMS_KEYS = ("sample_rate", "blurring_factor",
               "compression_model_latent_dim", "compression_model_framerate",
               "segment_duration")


PATTERN_PROVIDERS = {"parallel": ParallelPatternProvider,
                     "delay": DelayedPatternProvider,
                     "unroll": UnrolledPatternProvider,
                     "coarse_first": CoarseFirstPattern,
                     "musiclm": MusicLMPattern}


def get_codebooks_pattern_provider(n_q: int, cfg: dict
                                   ) -> CodebooksPatternProvider:
    name = cfg["modeling"]
    if name not in PATTERN_PROVIDERS:
        raise KeyError(f"unknown codebooks pattern {name!r}")
    return PATTERN_PROVIDERS[name](n_q, **dict(cfg.get(name, {}) or {}))


def get_lm_model(cfg: dict, device=None, seed: int = 0,
                 dtype=None) -> LMModel:
    """The LM of a solver config (`transformer_lm`, `codebooks_pattern`,
    `conditioners`, `fuser`, `classifier_free_guidance`), with seeded random
    weights: upstream's init of `weight_init` ('gaussian' or 'uniform')
    with the `depthwise_init` scaling ('current', 'global' or none) and
    `zero_bias_init`, else torch's default init. Parameters are
    f32 unless `dtype` (serving) names another; `transformer_lm.dtype` names
    the compute dtype, which the solver applies with autocast.
    `lm_model: transformer_lm_magnet` builds a `MagnetLMModel`: its
    `subcodes_context`, `compression_model_framerate` and
    `segment_duration` come from `transformer_lm`, its `span_len` from
    `masking` (default 3)."""
    device = resolve_device(device)
    kwargs = dict(cfg["transformer_lm"])
    for key in _DROPPED_LM_KEYS:
        kwargs.pop(key, None)
    weight_init = kwargs.pop("weight_init", None)
    depthwise_init = kwargs.pop("depthwise_init", None)
    zero_bias_init = kwargs.pop("zero_bias_init", False)
    lm_model = cfg.get("lm_model", "transformer_lm")
    if lm_model == "transformer_lm_magnet":
        lm_class: tp.Any = MagnetLMModel
        kwargs.setdefault("span_len", (cfg.get("masking") or {}).get(
            "span_len", 3))
    elif lm_model == "transformer_lm":
        lm_class = LMModel
    else:
        raise KeyError(f"unexpected LM model {lm_model!r}")
    n_q = kwargs["n_q"]
    pattern_cfg = cfg.get("codebooks_pattern") or {
        "modeling": "delay", "delay": {"delays": list(range(n_q))}}
    cfg_coef = (cfg.get("classifier_free_guidance", {}) or {}).get(
        "inference_coef", 1.0)
    with _seeded(device, seed):
        fuser = get_condition_fuser(cfg)
        conditioners = get_conditioners(kwargs["dim"], cfg, device=device,
                                        dtype=dtype)
        if fuser.fuse2cond.get("cross"):
            kwargs["cross_attention"] = True
        lm = lm_class(get_codebooks_pattern_provider(n_q, pattern_cfg),
                      conditioners, fuser, cfg_coef=cfg_coef, device=device,
                      dtype=dtype, **kwargs)
    if weight_init is not None:
        lm.reset_parameters(seed, weight_init, depthwise_init, zero_bias_init)
    return lm.eval()


# ------------------------------------------------------ MBD, AudioSeal, JASCO

_UNET_KEYS = ("hidden", "depth", "growth", "max_channels", "emb_all_layers",
              "cross_attention", "bilstm", "transformer", "codec_dim",
              "kernel", "stride", "norm_groups", "res_blocks", "dropout")
_SCHEDULE_KEYS = ("beta_t0", "beta_t1", "num_steps", "variance", "clip",
                  "rescale", "beta_exp", "repartition", "alpha_sigmoid",
                  "n_bands", "noise_scale")


def get_diffusion_band(cfg: dict, sample_rate: int, device=None,
                       seed: int = 0
                       ) -> tp.Tuple[DiffusionUnet, NoiseSchedule]:
    """One band of Multi-Band Diffusion from a diffusion solver config:
    the `DiffusionUnet` of `diffusion_unet` (over `channels`), and the
    `NoiseSchedule` of `schedule` with the `MultiBandProcessor` of
    `processor` when its `use` is set; torch's default init, seeded, f32,
    and the processor's statistics zero (empty), as before training."""
    device = resolve_device(device)
    unet_cfg = dict(cfg.get("diffusion_unet") or {})
    schedule_cfg = dict(cfg.get("schedule") or {})
    processor_cfg = dict(cfg.get("processor") or {})
    with _seeded(device, seed):
        model = DiffusionUnet(
            chin=cfg.get("channels", 1),
            num_steps=schedule_cfg.get("num_steps", 1000), device=device,
            **{k: v for k, v in unet_cfg.items() if k in _UNET_KEYS})
    processor = None
    if processor_cfg.pop("use", False):
        processor_cfg.pop("name", None)
        processor = MultiBandProcessor(sample_rate=sample_rate, device=device,
                                       **processor_cfg)
    schedule = NoiseSchedule(
        sample_processor=processor,
        **{k: v for k, v in schedule_cfg.items() if k in _SCHEDULE_KEYS})
    return model.eval(), schedule


def get_mbd_32khz(device=None, seed: int = 0) -> MultiBandDiffusion:
    """Multi-Band Diffusion for MusicGen's tokens at full width:
    `solver/diffusion/default` over `model/score/basic` at 32 kHz in 4
    bands (`grids/diffusion/4_bands_base_32khz`): per band a
    `DiffusionUnet` of hidden 48, depth 4, growth 4 (channels 48, 192,
    768, 3072), kernel 8, stride 4, one residual block, 4 groups, the step
    embedding at every layer, a BiLSTM of 3072 at the bottleneck and a
    128-dimensional codec condition; an 8-band processor; 1000 steps of
    the power schedule. Seeded random weights (band i from `seed + i`),
    f32; each processor's statistics are seeded too (counts 1, means 0,
    band variances and targets drawn in [0.5, 1.5] x 1e-3); the codec is
    `get_encodec_32khz(seed=seed + 4)`."""
    device = resolve_device(device)
    cfg = load_config("solver/diffusion/default")
    DPs = []
    for band in range(4):
        model, schedule = get_diffusion_band(cfg, 32000, device, seed + band)
        processor = schedule.sample_processor
        g = torch.Generator().manual_seed(seed + band)
        with torch.no_grad():
            processor.counts.fill_(1.0)
            for name in ("sum_x2", "sum_target_x2"):
                getattr(processor, name).copy_(
                    (0.5 + torch.rand(processor.n_bands, generator=g)) * 1e-3)
        DPs.append(DiffusionProcess(model, schedule))
    return MultiBandDiffusion(DPs, get_encodec_32khz(device=device,
                                                     seed=seed + 4),
                              device=device)


def get_audioseal_base(device=None, seed: int = 0) -> AudioSeal:
    """AudioSeal at the released `base` widths (the JAX loader's defaults):
    16 bits, SEANet dimension 128, 32 filters, ratios (8, 5, 4, 2), one
    residual layer, 2 LSTM layers, detector output 32; torch's default
    init (weight norm with g = |v|), seeded, f32."""
    device = resolve_device(device)
    kw = dict(nbits=16, dimension=128, n_filters=32, n_residual_layers=1,
              lstm=2, ratios=(8, 5, 4, 2), device=device)
    with _seeded(device, seed):
        generator = AudioSealWM(**kw)
        detector = AudioSealDetector(output_dim=32, **kw)
    return AudioSeal(generator, detector, nbits=16, device=device)


# keys of a JASCO `transformer_lm` that the flow-matching model does not take
# (the JAX builder drops them too)
_FLOW_KEYS = ("dim", "num_heads", "flow_dim", "chords_dim", "drums_dim",
              "melody_dim", "hidden_scale", "norm_first", "bias_proj",
              "time_embedding_dim", "num_layers", "skip_connections", "causal",
              "cross_attention", "activation")
_TEMPORAL_WIDTHS = {"chords": "chords_dim", "self_wav": "drums_dim",
                    "melody": "melody_dim"}


def get_jasco_model(cfg: dict, device=None, seed: int = 0
                    ) -> FlowMatchingModel:
    """JASCO's flow-matching model of a solver config (`transformer_lm`,
    `conditioners`, `fuser`, `classifier_free_guidance`), torch's default
    init, seeded. The input width of each temporal condition (chords,
    drums, melody) is its conditioner's `out_dim`: the JAX package's
    `Dense` infers it, and `solver/jasco/chords_drums` names no
    `drums_dim`; a config that names another width raises."""
    device = resolve_device(device)
    kwargs = {k: v for k, v in dict(cfg["transformer_lm"]).items()
              if k in _FLOW_KEYS}
    cfg_coef = (cfg.get("classifier_free_guidance") or {}).get(
        "inference_coef", 1.0)
    with _seeded(device, seed):
        fuser = get_condition_fuser(cfg)
        conditioners = get_conditioners(kwargs.get("dim", 512), cfg,
                                        device=device)
        if fuser.fuse2cond.get("cross"):
            kwargs["cross_attention"] = True
        for name, key in _TEMPORAL_WIDTHS.items():
            if name in conditioners:
                width = conditioners[name].output_proj.out_features
                if kwargs.get(key) not in (None, 0, width):
                    raise ValueError(f"{key}={kwargs[key]} but the {name!r} "
                                     f"conditioner gives {width}")
                kwargs[key] = width
        model = FlowMatchingModel(conditioners, fuser, cfg_coef=cfg_coef,
                                  device=device, **kwargs)
    return model.eval()


def get_debug_jasco_model(device=None, seed: int = 0) -> JASCO:
    """The debug JASCO, as the JAX package's: flow matching over the debug
    codec's 32-dim latents (dim 16, 4 heads, 2 layers with a skip, pre-norm),
    the text by cross-attention (lookup table), chords of card 194
    embedded to 8 and concatenated; no chord mapping, 1 s maximum."""
    device = resolve_device(device)
    with _seeded(device, seed):
        conditioners = {
            "description": LUTConditioner(n_bins=128, dim=16, output_dim=16,
                                          device=device),
            "chords": ChordsEmbConditioner(card=194, out_dim=8,
                                           device=device)}
        fuser = ConditionFuser({"cross": ["description"], "prepend": [],
                                "sum": [], "ignore": ["chords"],
                                "input_interpolate": []})
        model = FlowMatchingModel(conditioners, fuser, dim=16, num_heads=4,
                                  flow_dim=32, chords_dim=8, num_layers=2,
                                  skip_connections=True, norm_first=True,
                                  device=device)
    return JASCO("debug", get_debug_compression_model(device=device,
                                                      seed=seed),
                 model.eval(), max_duration=1.0, device=device)


def get_jasco_chords_drums_model(device=None, seed: int = 0
                                 ) -> FlowMatchingModel:
    """JASCO chords + drums at full width: `solver/jasco/chords_drums` at
    `model/lm/model_scale/small` (dim 1024, 16 heads, 24 layers, FFN 4096;
    the repo has no config of `facebook/jasco-chords-drums-400M` and its
    own base is 512 wide), T5-base by cross-attention, chords of card 194
    -> 16 and drum latents of the 32 kHz EnCodec (128 -> 16, blur 3)
    concatenated to the 128-dim flow, pre-norm, GELU, skip connections, no
    output bias, 500 frames for 10 s."""
    cfg = load_config("solver/jasco/chords_drums")
    cfg["transformer_lm"].update(
        load_config("model/lm/model_scale/small")["transformer_lm"])
    return get_jasco_model(cfg, device=device, seed=seed)
