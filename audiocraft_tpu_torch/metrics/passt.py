"""The PaSST audio classifier for the KLD metric (counterpart of
`audiocraft_tpu/metrics/passt.py`).

The preprocessing is hear21passt's `AugmentMelSTFT` in eval mode, on the
host in numpy: pre-emphasis 0.97; a centred, reflect-padded STFT with
n_fft 1024, hop 320 and a symmetric Hann of 800 zero-padded to 1024; the
power spectrogram; 128 Slaney mel bands with area norm; log(mel + 1e-5);
then (x + 4.5) / 5. The network is PaSST-S: a Conv2d patch embed (kernel
16, stride 10), frequency and time positional embeddings, cls and dist
tokens with `new_pos_embed`, pre-LN blocks (LayerNorm eps 1e-6, heads of
64, exact GELU), and the head (LayerNorm, Linear) over the mean of the two
tokens. Its parameter names are hear21passt's, so a released `passt.pt`
(bare, or with the `net.` prefix of `PasstBasicWrapper`) loads as it is;
the widths are read from the checkpoint.
"""
import math
import typing as tp
from pathlib import Path

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resample import resample_frac
from ..ops.stft import mel_filters
from ..utils.utils import (find_local_checkpoint, host_f32, no_tf32,
                           resolve_device)

SAMPLE_RATE = 32000
N_FFT = 1024
WIN_LENGTH = 800
HOP_LENGTH = 320
N_MELS = 128
N_CLASSES = 527
EMBED_DIM = 768
PATCH = 16
STRIDE = 10


# ------------------------------------------------------------ preprocessing

def passt_mel(wav, fmin: float = 0.0,
              fmax: tp.Optional[float] = None) -> np.ndarray:
    """[T] mono 32 kHz waveform -> [128, F] normalised log-mel."""
    x = host_f32(wav)
    x = x[1:] - 0.97 * x[:-1]          # pre-emphasis, a valid conv1d
    pad = N_FFT // 2
    x = np.pad(x, (pad, pad), mode="reflect")
    n_frames = 1 + (len(x) - N_FFT) // HOP_LENGTH
    idx = (np.arange(N_FFT)[None, :]
           + HOP_LENGTH * np.arange(n_frames)[:, None])
    window = np.hanning(WIN_LENGTH).astype(np.float32)   # symmetric
    lpad = (N_FFT - WIN_LENGTH) // 2
    window = np.pad(window, (lpad, N_FFT - WIN_LENGTH - lpad))
    spec = np.abs(np.fft.rfft(x[idx] * window, axis=-1)) ** 2
    fb = mel_filters(SAMPLE_RATE, N_FFT, N_MELS, fmin,
                     SAMPLE_RATE / 2 if fmax is None else fmax,
                     htk=False, norm="slaney")
    log_mel = np.log(spec @ fb + 1e-5).T                # [128, F]
    return ((log_mel + 4.5) / 5.0).astype(np.float32)


# ------------------------------------------------------------------ network

class PatchEmbed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(1, dim, PATCH, stride=STRIDE)


class Attention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.num_heads = max(dim // 64, 1)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, D = x.shape
        hd = D // self.num_heads
        q, k, v = self.qkv(x).reshape(B, N, 3, self.num_heads, hd).permute(
            2, 0, 3, 1, 4)
        att = torch.softmax(q @ k.transpose(-2, -1) / math.sqrt(hd), dim=-1)
        return self.proj((att @ v).transpose(1, 2).reshape(B, N, D))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class Block(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class PaSST(nn.Module):
    """[B, 128, F] normalised log-mel -> [B, n_classes] AudioSet logits."""

    def __init__(self, dim: int = EMBED_DIM, depth: int = 12,
                 mlp_hidden: int = 4 * EMBED_DIM, n_classes: int = N_CLASSES,
                 freq_patches: int = (N_MELS - PATCH) // STRIDE + 1,
                 time_patches: int = 99, device=None):
        super().__init__()
        self.patch_embed = PatchEmbed(dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.dist_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.new_pos_embed = nn.Parameter(torch.zeros(1, 2, dim))
        self.freq_new_pos_embed = nn.Parameter(
            torch.zeros(1, dim, freq_patches, 1))
        self.time_new_pos_embed = nn.Parameter(
            torch.zeros(1, dim, 1, time_patches))
        self.blocks = nn.ModuleList([Block(dim, mlp_hidden)
                                     for _ in range(depth)])
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.head = nn.Sequential(nn.LayerNorm(dim, eps=1e-6),
                                  nn.Linear(dim, n_classes))
        self.to(device)

    @classmethod
    def from_state_dict(cls, state: tp.Mapping[str, torch.Tensor],
                        device=None) -> "PaSST":
        """The network with the checkpoint's widths and weights; keys the
        network does not have (`head_dist`, a wrapper's mel module) are
        left out, a missing one raises."""
        if any(k.startswith("net.") for k in state):
            state = {k[len("net."):]: v for k, v in state.items()
                     if k.startswith("net.")}
        dim = state["cls_token"].shape[-1]
        depth = 1 + max(int(k.split(".")[1]) for k in state
                        if k.startswith("blocks."))
        model = cls(dim=dim, depth=depth,
                    mlp_hidden=state["blocks.0.mlp.fc1.weight"].shape[0],
                    n_classes=state["head.1.weight"].shape[0],
                    freq_patches=state["freq_new_pos_embed"].shape[2],
                    time_patches=state["time_new_pos_embed"].shape[3],
                    device=device)
        own = model.state_dict()
        model.load_state_dict({k: torch.as_tensor(state[k]) for k in own})
        return model.eval()

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed.proj(mel[:, None])        # [B, D, F', T']
        B, D, Fp, Tp = x.shape
        assert Tp <= self.time_new_pos_embed.shape[-1], (
            f"input longer than the pretrained time positions "
            f"({Tp} > {self.time_new_pos_embed.shape[-1]})")
        x = x + self.freq_new_pos_embed[:, :, :Fp]
        x = x + self.time_new_pos_embed[..., :Tp]
        x = x.flatten(2).transpose(1, 2)               # frequency-major
        cls = (self.cls_token + self.new_pos_embed[:, :1]).expand(B, -1, -1)
        dist = (self.dist_token + self.new_pos_embed[:, 1:]).expand(B, -1, -1)
        x = torch.cat([cls, dist, x], dim=1)
        for block in self.blocks:
            x = block(x)
        x = self.norm(x)
        return self.head((x[:, 0] + x[:, 1]) / 2.0)


# ------------------------------------------------------------ weight loading

def load_passt_params(path: tp.Union[str, Path]) -> tp.Dict[str, torch.Tensor]:
    """The state dict of a hear21passt `.pt` (bare or `net.`-prefixed
    keys, or under 'state_dict') or of an `.npz` of the same names."""
    path = Path(path)
    if path.suffix == ".npz":
        with np.load(path) as data:
            return {k: torch.from_numpy(data[k]) for k in data.files}
    state = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(state, "state_dict"):
        state = state.state_dict()
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    return dict(state)


def find_passt_checkpoint() -> tp.Optional[Path]:
    """$PASST_CHECKPOINT, then passt.{pt,pth,npz} under
    $AUDIOCRAFT_CACHE_DIR."""
    return find_local_checkpoint(
        "PASST_CHECKPOINT",
        ("passt.pt", "passt.pth", "passt.npz", "passt/passt.pt"))


class PasstClassifier:
    """wav [B, C, T] + sample rate -> [B, n_classes] class probabilities:
    each row mixed to mono and resampled to 32 kHz on the host, cut into
    segments of at most `max_duration` (and of what the time positions
    admit: with P time patches the patch conv takes at most 10 P + 15 mel
    frames, (10 P + 14) * 320 + 1 samples), a tail of `min_duration` or
    less dropped (an input that is all too short padded to one segment);
    each segment's softmax through the network of the checkpoint `state`
    on `device` in f32 without TF32, then their mean."""

    def __init__(self, state: tp.Mapping[str, torch.Tensor],
                 max_duration: float = 10.0, min_duration: float = 0.15,
                 device=None):
        self.model = PaSST.from_state_dict(state, resolve_device(device))
        P = int(self.model.time_new_pos_embed.shape[-1])
        self.max_frames = min(int(max_duration * SAMPLE_RATE),
                              (10 * P + 14) * HOP_LENGTH + 1)
        self.min_frames = int(min_duration * SAMPLE_RATE)

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @torch.no_grad()
    def __call__(self, wav, sample_rate: int) -> np.ndarray:
        wav = host_f32(wav)
        out = np.zeros((wav.shape[0], self.model.head[1].out_features),
                       np.float32)
        for b in range(wav.shape[0]):
            mono = wav[b].mean(axis=0)
            if sample_rate != SAMPLE_RATE:
                mono = resample_frac(torch.from_numpy(mono), sample_rate,
                                     SAMPLE_RATE).numpy()
            segs = [mono[s:s + self.max_frames]
                    for s in range(0, max(len(mono), 1), self.max_frames)]
            segs = [s for s in segs if len(s) > self.min_frames]
            if not segs:
                segs = [np.pad(mono, (0, self.min_frames + 1 - len(mono)))]
            probs = []
            for seg in segs:
                mel = torch.from_numpy(passt_mel(seg)[None]).to(self.device)
                with no_tf32():
                    logits = self.model(mel)
                probs.append(torch.softmax(logits, dim=-1)[0].cpu().numpy())
            out[b] = np.mean(probs, axis=0)
        return out
