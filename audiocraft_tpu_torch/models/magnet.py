"""MAGNeT: non-autoregressive text-to-music (counterpart of
`audiocraft_tpu/models/magnet.py`): the user-facing wrapper over
`MagnetLMModel.generate`, with MAGNeT's generation defaults."""
import typing as tp

from .genmodel import BaseGenModel


class MAGNeT(BaseGenModel):
    """Text -> music (or sound) with MAGNeT's iterative masked decoding.
    Defaults: 10 s, top-p 0.9 at temperature 3 (annealed), CFG annealed
    from 10 to 1, [20, 10, 10, 10] decoding steps, non-overlapping
    spans."""

    def __init__(self, name, compression_model, lm, max_duration: float = 10,
                 device=None):
        super().__init__(name, compression_model, lm, max_duration, device)
        self.set_generation_params(duration=10)

    @staticmethod
    def get_pretrained(name: str = "facebook/magnet-small-10secs",
                       device=None) -> "MAGNeT":
        """The `debug` model (tiny, seeded random weights, over the debug
        codec at 25 Hz) or a checkpoint from local export packages, read
        as the JAX package reads them (`loaders.load_lm_model`: its config
        names `lm_model: transformer_lm_magnet`). Nothing is downloaded."""
        from . import builders, loaders
        if name == "debug":
            return MAGNeT(name,
                          builders.get_debug_compression_model(device=device),
                          builders.get_debug_magnet_lm_model(device=device),
                          max_duration=10, device=device)
        codec = loaders.load_compression_model(name, device=device)
        lm, cfg = loaders.load_lm_model(name, device=device)
        return MAGNeT(name, codec, lm,
                      max_duration=cfg["dataset"]["segment_duration"],
                      device=device)

    def set_generation_params(self, use_sampling: bool = True, top_k: int = 0,
                              top_p: float = 0.9, temperature: float = 3.0,
                              max_cfg_coef: float = 10.0,
                              min_cfg_coef: float = 1.0,
                              decoding_steps: tp.Sequence[int] = (20, 10, 10,
                                                                  10),
                              span_arrangement: str = "nonoverlap",
                              duration: float = 10.0):
        """MAGNeT's sampling, CFG annealing, steps per stage, span
        arrangement ('nonoverlap' or 'stride1') and the duration."""
        self.duration = duration
        self.generation_params = {
            "use_sampling": use_sampling,
            "temp": temperature,
            "top_k": top_k,
            "top_p": top_p,
            "max_cfg_coef": max_cfg_coef,
            "min_cfg_coef": min_cfg_coef,
            "decoding_steps": tuple(int(s) for s in decoding_steps),
            "span_arrangement": span_arrangement,
        }

    def _lm_generate(self, prompt_tokens, attributes, max_gen_len: int):
        return self.lm.generate(prompt_tokens, attributes,
                                max_gen_len=max_gen_len,
                                callback=self._progress_callback,
                                generator=self.generator, device=self.device,
                                **self.generation_params)
