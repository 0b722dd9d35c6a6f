"""VGGish audio embeddings for FAD (counterpart of
`audiocraft_tpu/metrics/vggish.py`).

The preprocessing is Google's `vggish_input.waveform_to_examples` on the
host in numpy: 16 kHz mono, a periodic Hann STFT of 400 / 160 samples
(25 / 10 ms) through an FFT of 512, 64 HTK mel bands over 125-7500 Hz with
the DC bin zeroed, log(mel + 0.01), and non-overlapping examples of 96
frames (0.96 s). The network is torchvggish's `VGG`: six 3 x 3
convolutions (64, 128, 256, 256, 512, 512 channels) with max pools after
the first, second, fourth and sixth, then 12288 -> 4096 -> 4096 -> 128,
each with a ReLU. Its `state_dict` keys are torchvggish's
(`features.{0,3,6,8,11,13}`, `embeddings.{0,2,4}`), so a released
`vggish.pth` loads as it is; the widths are read from the checkpoint.
"""
import typing as tp
from pathlib import Path

import numpy as np
import torch
import torch.nn as nn

from ..ops.resample import resample_frac
from ..utils.utils import (find_local_checkpoint, host_f32, no_tf32,
                           resolve_device)

SAMPLE_RATE = 16000
STFT_WINDOW = 400   # 25 ms
STFT_HOP = 160      # 10 ms
NUM_MEL_BINS = 64
MEL_MIN_HZ = 125.0
MEL_MAX_HZ = 7500.0
LOG_OFFSET = 0.01
EXAMPLE_FRAMES = 96  # 0.96 s per example
EMBEDDING_SIZE = 128

# the convolutions' indices in `features`, and whether a max pool follows
_CONVS = ((0, True), (3, True), (6, False), (8, True), (11, False), (13, True))
_LINEARS = (0, 2, 4)


# ------------------------------------------------------------ preprocessing

def _hertz_to_mel(f):
    return 1127.0 * np.log(1.0 + np.asarray(f, np.float64) / 700.0)


def _mel_matrix(num_spectrogram_bins: int, audio_sample_rate: float
                ) -> np.ndarray:
    """Google's `mel_features.spectrogram_to_mel_matrix` (HTK mel scale),
    [num_spectrogram_bins, NUM_MEL_BINS]."""
    nyquist = audio_sample_rate / 2.0
    bins_mel = _hertz_to_mel(np.linspace(0.0, nyquist, num_spectrogram_bins))
    edges = np.linspace(_hertz_to_mel(MEL_MIN_HZ), _hertz_to_mel(MEL_MAX_HZ),
                        NUM_MEL_BINS + 2)
    weights = np.empty((num_spectrogram_bins, NUM_MEL_BINS))
    for i in range(NUM_MEL_BINS):
        lower, center, upper = edges[i:i + 3]
        weights[:, i] = np.maximum(0.0, np.minimum(
            (bins_mel - lower) / (center - lower),
            (upper - bins_mel) / (upper - center)))
    weights[0, :] = 0.0  # the DC bin never contributes
    return weights.astype(np.float32)


def waveform_to_examples(wav, sample_rate: int) -> np.ndarray:
    """[T] or [C, T] float waveform -> [N, 96, 64] log-mel examples; none
    for a waveform shorter than one example."""
    data = host_f32(wav)
    if data.ndim == 2:
        data = data.mean(axis=0)
    if sample_rate != SAMPLE_RATE:
        data = resample_frac(torch.from_numpy(data), sample_rate,
                             SAMPLE_RATE).numpy()
    empty = np.zeros((0, EXAMPLE_FRAMES, NUM_MEL_BINS), np.float32)
    if len(data) < STFT_WINDOW:
        return empty
    num_frames = 1 + (len(data) - STFT_WINDOW) // STFT_HOP
    idx = (np.arange(STFT_WINDOW)[None, :]
           + STFT_HOP * np.arange(num_frames)[:, None])
    window = 0.5 - 0.5 * np.cos(2 * np.pi / STFT_WINDOW
                                * np.arange(STFT_WINDOW))
    spec = np.abs(np.fft.rfft(data[idx] * window, n=512, axis=-1))
    log_mel = np.log(spec @ _mel_matrix(spec.shape[-1], SAMPLE_RATE)
                     + LOG_OFFSET)                   # [frames, 64]
    n = log_mel.shape[0] // EXAMPLE_FRAMES
    if n == 0:
        return empty
    return log_mel[:n * EXAMPLE_FRAMES].reshape(
        n, EXAMPLE_FRAMES, NUM_MEL_BINS).astype(np.float32)


# ------------------------------------------------------------------ network

class VGGish(nn.Module):
    """torchvggish's `VGG`: [N, 96, 64] log-mel examples -> [N, 128]."""

    def __init__(self, channels: tp.Sequence[int] = (64, 128, 256, 256, 512,
                                                     512),
                 hidden: tp.Sequence[int] = (4096, 4096),
                 embedding: int = EMBEDDING_SIZE, device=None):
        super().__init__()
        layers: tp.List[nn.Module] = []
        in_ch = 1
        for ch, (_, pool) in zip(channels, _CONVS):
            layers += [nn.Conv2d(in_ch, ch, 3, padding=1), nn.ReLU(True)]
            if pool:
                layers.append(nn.MaxPool2d(2, 2))
            in_ch = ch
        self.features = nn.Sequential(*layers)
        flat = in_ch * (EXAMPLE_FRAMES // 16) * (NUM_MEL_BINS // 16)
        dims = [flat, *hidden, embedding]
        fcs: tp.List[nn.Module] = []
        for a, b in zip(dims, dims[1:]):
            fcs += [nn.Linear(a, b), nn.ReLU(True)]
        self.embeddings = nn.Sequential(*fcs)
        self.to(device)

    @classmethod
    def from_state_dict(cls, state: tp.Mapping[str, torch.Tensor],
                        device=None) -> "VGGish":
        """The network with the checkpoint's widths and weights."""
        channels = [state[f"features.{i}.weight"].shape[0] for i, _ in _CONVS]
        dims = [state[f"embeddings.{i}.weight"].shape[0] for i in _LINEARS]
        model = cls(channels, dims[:2], dims[2], device=device)
        model.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
        return model.eval()

    def forward(self, examples: torch.Tensor) -> torch.Tensor:
        x = self.features(examples[:, None])         # [N, C, 6, 4]
        # torchvggish flattens channels-last, as the TF original did
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return self.embeddings(x)


def load_vggish_params(path: tp.Union[str, Path]) -> tp.Dict[str, torch.Tensor]:
    """The state dict of a torchvggish `.pth` or of an `.npz` of the same
    names."""
    path = Path(path)
    if path.suffix == ".npz":
        with np.load(path) as data:
            return {k: torch.from_numpy(data[k]) for k in data.files}
    state = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(state, "state_dict"):
        state = state.state_dict()
    return dict(state)


def find_vggish_checkpoint() -> tp.Optional[Path]:
    """$VGGISH_CHECKPOINT, then vggish.{pth,npz} under
    $AUDIOCRAFT_CACHE_DIR."""
    return find_local_checkpoint(
        "VGGISH_CHECKPOINT",
        ("vggish.pth", "vggish.npz", "vggish/vggish.pth"))


class VGGishEmbedder:
    """wav [B, C, T] + sample rate -> [N, 128]: each row's examples (host),
    through the network of the checkpoint `state` on `device` in batches of
    `batch_size`, in f32 without TF32."""

    def __init__(self, state: tp.Mapping[str, torch.Tensor],
                 batch_size: int = 64, device=None):
        self.model = VGGish.from_state_dict(state, resolve_device(device))
        self.batch_size = batch_size

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @torch.no_grad()
    def __call__(self, wav, sample_rate: int) -> np.ndarray:
        outs = []
        for row in host_f32(wav):
            examples = waveform_to_examples(row, sample_rate)
            for s in range(0, examples.shape[0], self.batch_size):
                batch = torch.from_numpy(examples[s:s + self.batch_size])
                with no_tf32():
                    outs.append(self.model(batch.to(self.device)).cpu().numpy())
        if not outs:
            # the network's own width (the JAX package's is always 128,
            # which a narrower checkpoint's embeddings cannot join)
            width = self.model.embeddings[-2].out_features
            return np.zeros((0, width), np.float32)
        return np.concatenate(outs)
