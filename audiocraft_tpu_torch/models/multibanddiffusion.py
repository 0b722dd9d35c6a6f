"""Multi-Band Diffusion: diffusion decoding of EnCodec tokens (counterpart
of `audiocraft_tpu/models/multibanddiffusion.py`). One `DiffusionProcess`
per mel frequency band regenerates its band from the codec's latent
condition, the bands are summed, and `tokens_to_wav` matches the EQ of the
result to the codec's own decode over 32 bands.
"""
import typing as tp

import torch

from ..modules.diffusion_schedule import NoiseSchedule
from ..ops.filters import SplitBands
from ..ops.resample import resample_frac
from ..utils.utils import resolve_device
from .encodec import CompressionModel
from .unet import DiffusionUnet


class DiffusionProcess:
    """A band's denoiser and its noise schedule (with its processor)."""

    def __init__(self, model: DiffusionUnet, noise_schedule: NoiseSchedule):
        self.model = model
        self.schedule = noise_schedule

    def generate(self, condition: torch.Tensor, initial_noise: torch.Tensor,
                 step_list: tp.Optional[tp.List[int]] = None,
                 generator: tp.Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        return self.schedule.generate_subsampled(
            self.model, initial_noise, step_list=step_list,
            condition=condition, generator=generator)


class MultiBandDiffusion:
    """Sample from per-band diffusion models over a compression model, all
    on one device (CUDA unless `device` names another). The Gaussian
    draws come from `self.generator`, seeded 0."""

    def __init__(self, DPs: tp.List[DiffusionProcess],
                 codec_model: CompressionModel, device=None):
        self.device = resolve_device(device)
        self.DPs = DPs
        for DP in DPs:
            DP.model.to(self.device).eval()
            DP.schedule.sample_processor.to(self.device)
        self.codec_model = codec_model.to(self.device).eval()
        self.generator = torch.Generator(self.device).manual_seed(0)

    @property
    def sample_rate(self) -> int:
        return self.codec_model.sample_rate

    @staticmethod
    def from_checkpoint(name: str, codec_name: str,
                        filename: tp.Optional[str] = None,
                        device=None) -> "MultiBandDiffusion":
        """The diffusion bundle at `name` (`loaders.load_diffusion_models`)
        over the codec of the export package at `codec_name`, both read
        from local paths."""
        from . import loaders
        models, schedules, _, _ = loaders.load_diffusion_models(
            name, filename=filename, device=device)
        codec = loaders.load_compression_model(codec_name, device=device)
        return MultiBandDiffusion(
            [DiffusionProcess(m, s) for m, s in zip(models, schedules)],
            codec, device=device)

    @staticmethod
    def get_mbd_musicgen(device=None) -> "MultiBandDiffusion":
        """The MBD for MusicGen's tokens: `mbd_musicgen_32khz.th` of a local
        `facebook/multiband-diffusion` snapshot over a local
        `facebook/musicgen-small` codec."""
        return MultiBandDiffusion.from_checkpoint(
            "facebook/multiband-diffusion", "facebook/musicgen-small",
            filename="mbd_musicgen_32khz.th", device=device)

    @staticmethod
    def get_mbd_24khz(bw: float = 3.0, device=None) -> "MultiBandDiffusion":
        """The MBD for EnCodec 24 kHz at `bw` kbps, from local snapshots."""
        assert bw in (1.5, 3.0, 6.0), f"bandwidth {bw} not available"
        return MultiBandDiffusion.from_checkpoint(
            "facebook/multiband-diffusion", "facebook/encodec_24khz",
            filename=f"mbd_comp_{int(bw * 2)}.pt", device=device)

    @torch.no_grad()
    def get_condition(self, wav: torch.Tensor, sample_rate: int
                      ) -> torch.Tensor:
        """Waveform [B, C, T] -> the codec's latent condition [B, D, T']."""
        wav = torch.as_tensor(wav, dtype=torch.float32).to(self.device)
        if sample_rate != self.sample_rate:
            wav = resample_frac(wav, sample_rate, self.sample_rate)
        codes, scale = self.codec_model.encode(wav, device=self.device)
        assert scale is None, "Scaled compression models not supported."
        return self.get_emb(codes)

    @torch.no_grad()
    def get_emb(self, codes: torch.Tensor) -> torch.Tensor:
        """Tokens [B, K, T'] -> the latent condition [B, D, T']."""
        return self.codec_model.decode_latent(
            codes.to(self.device)).transpose(1, 2)

    @torch.no_grad()
    def generate(self, emb: torch.Tensor,
                 size: tp.Optional[tp.Sequence[int]] = None,
                 step_list: tp.Optional[tp.List[int]] = None) -> torch.Tensor:
        """Latent condition [B, D, T'] -> waveform [B, C, T]: per band one
        initial noise and one reverse process, summed."""
        if size is None:
            upsampling = int(self.codec_model.sample_rate
                             / self.codec_model.frame_rate)
            size = (emb.shape[0], self.codec_model.channels,
                    emb.shape[-1] * upsampling)
        assert size[0] == emb.shape[0]
        out = torch.zeros(tuple(size), device=self.device)
        for DP in self.DPs:
            initial = DP.schedule.get_initial_noise(out, self.generator)
            out = out + DP.generate(emb, initial, step_list, self.generator)
        return out

    @torch.no_grad()
    def re_eq(self, wav: torch.Tensor, ref: torch.Tensor, n_bands: int = 32,
              strictness: float = 1.0) -> torch.Tensor:
        """Match the energy of each of `n_bands` mel bands of `wav` to
        `ref`'s."""
        split = SplitBands(self.sample_rate, n_bands)
        bands, bands_ref = split(wav), split(ref)
        energy = bands.pow(2).mean(dim=(1, 2, 3), keepdim=True).sqrt()
        energy_ref = bands_ref.pow(2).mean(dim=(1, 2, 3), keepdim=True).sqrt()
        return (bands * (energy_ref / energy.clamp_min(1e-12)) ** strictness
                ).sum(dim=0)

    @torch.no_grad()
    def regenerate(self, wav: torch.Tensor, sample_rate: int) -> torch.Tensor:
        """Waveform [B, C, T] -> codec condition -> diffusion waveform at
        the model's sample rate."""
        emb = self.get_condition(wav, sample_rate)
        size = tuple(wav.shape)
        if sample_rate != self.sample_rate:
            size = (wav.shape[0], self.codec_model.channels,
                    int(wav.shape[-1] * self.sample_rate / sample_rate))
        return self.generate(emb, size=size)

    @torch.no_grad()
    def tokens_to_wav(self, tokens: torch.Tensor, n_bands: int = 32
                      ) -> torch.Tensor:
        """Tokens [B, K, T'] -> the diffusion waveform, its EQ matched to
        the codec's decode of the same tokens."""
        tokens = torch.as_tensor(tokens).to(self.device)
        wav_encodec = self.codec_model.decode(tokens, device=self.device)
        wav_diffusion = self.generate(self.get_emb(tokens),
                                      size=tuple(wav_encodec.shape))
        return self.re_eq(wav_diffusion, wav_encodec, n_bands=n_bands)
