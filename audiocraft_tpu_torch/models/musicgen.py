"""MusicGen: text-conditioned music generation (counterpart of
`audiocraft_tpu/models/musicgen.py`)."""
import typing as tp

from .genmodel import BaseGenModel

# upstream's names of the released checkpoints, resolved as local paths
HF_MODEL_CHECKPOINTS_MAP = {
    "small": "facebook/musicgen-small",
    "medium": "facebook/musicgen-medium",
    "large": "facebook/musicgen-large",
    "melody": "facebook/musicgen-melody",
    "style": "facebook/musicgen-style",
    "stereo-small": "facebook/musicgen-stereo-small",
    "stereo-medium": "facebook/musicgen-stereo-medium",
    "stereo-large": "facebook/musicgen-stereo-large",
    "stereo-melody": "facebook/musicgen-stereo-melody",
}


class MusicGen(BaseGenModel):
    """Text -> music. Defaults: duration 15 s (capped by `max_duration`),
    sampling with top-k 250, CFG coefficient 3."""

    def __init__(self, name, compression_model, lm, max_duration: float = 30,
                 device=None):
        super().__init__(name, compression_model, lm, max_duration, device)
        self.set_generation_params(duration=min(15, self.max_duration),
                                   extend_stride=min(18, self.max_duration / 2))

    @staticmethod
    def get_pretrained(name: str = "debug", device=None) -> "MusicGen":
        """The `debug` model or its interleaved-stereo twin `debug-stereo`
        (tiny, seeded random weights), or a checkpoint from local files:
        `name` (a released model's short name like 'small' maps to its
        upstream name first) is a directory or file of audiocraft export
        packages, or one under `AUDIOCRAFT_CACHE_DIR`
        (`models/loaders.py`). Nothing is downloaded: a name with no local
        files raises FileNotFoundError."""
        from . import builders, loaders
        if name in ("debug", "debug-stereo"):
            codec = builders.get_debug_compression_model(device=device)
            if name == "debug":
                lm = builders.get_debug_lm_model(device=device)
            else:
                codec = builders.get_wrapped_compression_model(
                    codec, {"interleave_stereo_codebooks": {"use": True}})
                lm = builders.get_debug_stereo_lm_model(device=device)
            return MusicGen(name, codec, lm, max_duration=30, device=device)
        name = HF_MODEL_CHECKPOINTS_MAP.get(name, name)
        codec = loaders.load_compression_model(name, device=device)
        lm, cfg = loaders.load_lm_model(name, device=device)
        # stereo checkpoints name the interleave in their config
        codec = builders.get_wrapped_compression_model(codec, cfg)
        return MusicGen(name, codec, lm,
                        max_duration=cfg["dataset"]["segment_duration"],
                        device=device)

    def set_generation_params(self, use_sampling: bool = True, top_k: int = 250,
                              top_p: float = 0.0, temperature: float = 1.0,
                              duration: float = 30.0, cfg_coef: float = 3.0,
                              cfg_coef_beta: tp.Optional[float] = None,
                              two_step_cfg: bool = False,
                              extend_stride: float = 18):
        """Sampling, CFG (`two_step_cfg` runs the conditional and null
        forwards as two streams) and durations. Double CFG (`cfg_coef_beta`)
        makes `LMModel.generate` raise: it needs a melody or style model."""
        assert extend_stride < self.max_duration, \
            "Cannot stride by more than max generation duration."
        self.extend_stride = extend_stride
        self.duration = duration
        self.generation_params = {
            "use_sampling": use_sampling,
            "temp": temperature,
            "top_k": top_k,
            "top_p": top_p,
            "cfg_coef": cfg_coef,
            "cfg_coef_beta": cfg_coef_beta,
            "two_step_cfg": two_step_cfg,
        }
