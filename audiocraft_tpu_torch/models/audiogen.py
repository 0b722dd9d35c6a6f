"""AudioGen: text-conditioned sound generation at 16 kHz (counterpart of
`audiocraft_tpu/models/audiogen.py`)."""
from .genmodel import BaseGenModel


class AudioGen(BaseGenModel):
    """Text -> sound. Defaults: duration 10 s, sampling with top-k 250, CFG
    coefficient 3, and past `max_duration` a window that moves by 2 s."""

    def __init__(self, name, compression_model, lm, max_duration: float = 10,
                 device=None):
        super().__init__(name, compression_model, lm, max_duration, device)
        self.set_generation_params(duration=10)

    @staticmethod
    def get_pretrained(name: str = "debug", device=None) -> "AudioGen":
        """The `debug` model (the debug LM over a tiny 16 kHz codec, seeded
        random weights, 10 s windows) or a checkpoint from local files, as
        `MusicGen.get_pretrained` reads them. AudioGen takes no waveform
        condition: a checkpoint with one is refused."""
        from . import builders, loaders
        if name == "debug":
            codec = builders.get_debug_compression_model(device=device,
                                                         sample_rate=16000)
            lm = builders.get_debug_lm_model(device=device)
            return AudioGen(name, codec, lm, max_duration=10, device=device)
        codec = loaders.load_compression_model(name, device=device)
        lm, cfg = loaders.load_lm_model(name, device=device)
        assert "self_wav" not in lm.condition_provider.conditioners, \
            "AudioGen do not support waveform conditioning for now"
        return AudioGen(name, codec, lm,
                        max_duration=cfg["dataset"]["segment_duration"],
                        device=device)

    def set_generation_params(self, use_sampling: bool = True, top_k: int = 250,
                              top_p: float = 0.0, temperature: float = 1.0,
                              duration: float = 10.0, cfg_coef: float = 3.0,
                              two_step_cfg: bool = False,
                              extend_stride: float = 2):
        """Sampling, CFG and durations; past `max_duration` the window
        moves by `extend_stride` seconds."""
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
            "two_step_cfg": two_step_cfg,
        }
